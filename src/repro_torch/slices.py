"""What later slices of the port carry.

Every module of ``repro`` has its counterpart in ``repro_torch`` and
every entry point runs.  Three pieces of the reference are still
missing (``ROADMAP.md``, Queue 1, items 11-13): bf16 operands through
the EF kernels, the dry run's ``--serve-mode``, ``--codec-dtype`` and
``--shard-activations``, and the model's ``shard_activations``.  None
of them has an entry point that raises, so :data:`LATER`, which named
the slice that would port each piece an entry point refused, is empty.
"""
from __future__ import annotations

LATER: dict = {}
