"""What later slices of the port carry.

Every module of ``repro`` has its counterpart in ``repro_torch`` and
every entry point runs, the query-chunked attention, the model's
``shard_activations`` and the dry run's ``--serve-mode``,
``--codec-dtype``, ``--shard-activations`` and ``--hierarchical``
among them; every name the reference's packages export is exported,
but for ``dist.compat``, ``kernels.ef_fused.use_backend`` and
``serve.decode_shardings`` (jax's own machinery).  One piece of the
reference is still missing (``ROADMAP.md``, Queue 1): bf16 operands
through the EF kernels, whose CUDA kernels take f32 alone.  No entry
point raises for it, so :data:`LATER`, which named the slice that would
port each piece an entry point refused, is empty.
"""
from __future__ import annotations

LATER: dict = {}
