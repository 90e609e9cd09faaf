"""Which slice of the port carries what this slice does not.

Single source for the ``NotImplementedError`` messages raised by the
train step, the train state and the CLIs: each names the slice (and
the ``ROADMAP.md`` queue item) that will port the missing piece.
"""
from __future__ import annotations

LATER = {
    "model_placement": "a later slice of the model axis (the model-axis "
                       "placement of serving: serve_param_specs, "
                       "cache_specs and make_apply_delta on a sharded "
                       "replica; --publish-every under tensor "
                       "parallelism; ROADMAP Queue 1 item 7.2)",
}


def not_ported(what: str, key: str) -> NotImplementedError:
    """``NotImplementedError`` for ``what``, naming the slice that ports
    ``key`` (a :data:`LATER` entry)."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: it lands in {LATER[key]}")
