"""What later slices of the port carry: nothing is left.

Every module of ``repro`` has its counterpart in ``repro_torch`` and
every entry point runs (``ROADMAP.md``, Queue 1).  :data:`LATER`, which
named the slice that would port each missing piece, is empty.
"""
from __future__ import annotations

LATER: dict = {}
