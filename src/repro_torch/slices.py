"""What later slices of the port carry.

Every module of ``repro`` has its counterpart in ``repro_torch`` and
every entry point runs, the query-chunked attention, the model's
``shard_activations`` and the dry run's ``--serve-mode``,
``--codec-dtype``, ``--shard-activations`` and ``--hierarchical``
among them; every name the reference's packages export is exported,
but for ``dist.compat``, ``kernels.ef_fused.use_backend`` and
``serve.decode_shardings`` (jax's own machinery).  bf16 runs end to
end: the EF kernels take bf16 operands, the dry run counts at the
reference's bf16 dtypes, a bf16 train state is checkpointed in the
reference's ``|V2`` entries, and bf16 serving is held against the
reference.  Deliberately not ported (``ROADMAP.md``): ``launch/
hlo_cost.py`` (torch has no HLO; ``launch/step_cost.py`` stands in),
``dist/compat.py``, ``kernels/*/ref.py`` (each kernel module has its
plain version), ``launch/mesh.make_production_mesh``,
``launch/env.merge_xla_flags`` and ``--host-devices``, the multihost
flags that torchrun's environment carries, the tuning CLI's
``--backend``, ``serve.decode_shardings``,
``train.state.abstract_train_state`` and
``kernels.ef_fused.use_backend``.  No entry point raises for a missing
piece, so :data:`LATER`, which named the slice that would port each
piece an entry point refused, is empty.
"""
from __future__ import annotations

LATER: dict = {}
