"""Serve-step factories: prefill and decode on one device, and the
serving specs (port of ``repro/serve/steps.py``: ``make_prefill_step``,
``make_decode_step``, ``serve_param_specs`` and the spec half of
``decode_shardings``).

The reference jits both steps with explicit shardings over a mesh.
Here every step runs on one device, the card unless told ``"cpu"``,
and a data axis of the mesh is the same function computed on the whole
batch.  The specs the reference places its params and caches by are
computed (:func:`serve_param_specs`, :func:`decode_specs`), as tuples
of ``repro_torch.dist.sharding``; placing them on several cards comes
in a later slice.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.devices import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import (data_axes_of, data_world_size,
                                     model_axis_size, parse_mesh)
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models.config import ModelConfig


def serve_param_specs(params, mesh, mode: str = "2d"):
    """Param specs for serving.  ``"2d"``: the model axis by the train
    rules plus the joint data axes on the largest remaining dim that
    divides (ZeRO-3-style at rest); ``"model-only"``: the model axis
    alone.  ``params`` may be meta tensors; returns ``{path name:
    spec}``, as ``dist.sharding.param_specs``."""
    mesh = parse_mesh(mesh)
    data_axes = data_axes_of(mesh)
    dsize = data_world_size(mesh)
    msize = model_axis_size(mesh)
    joint = data_axes if len(data_axes) > 1 else data_axes[0]

    def spec_of(path, leaf):
        shape = tuple(leaf.shape)
        base = shd.param_spec(path, leaf, "model", msize)
        spec = list(base) + [None] * (len(shape) - len(base))
        if mode == "2d":
            for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
                if spec[d] is None and shape[d] % dsize == 0 and \
                        shape[d] >= dsize:
                    spec[d] = joint
                    break
        return tuple(spec)

    return shd.by_leaf(params, spec_of)


def decode_specs(cfg: ModelConfig, mesh, batch: int, s_max: int,
                 cache_dtype=None):
    """``(param specs, cache specs, token spec)`` for decode: the specs
    of the reference's ``decode_shardings``, from meta shapes."""
    mesh = parse_mesh(mesh)
    data_axes = data_axes_of(mesh)
    dsize = data_world_size(mesh)
    joint = data_axes if len(data_axes) > 1 else data_axes[0]
    pspecs = serve_param_specs(init_params(cfg, 0, "meta"), mesh)
    cspecs = shd.cache_specs(
        init_cache(cfg, batch, s_max, cache_dtype, device="meta"),
        data_axes, dsize, "model", model_axis_size(mesh))
    tok_spec = (joint,) if batch % dsize == 0 and batch >= dsize else ()
    return pspecs, cspecs, tok_spec


def make_prefill_step(cfg: ModelConfig, device="cuda", *,
                      s_max: Optional[int] = None, cache_dtype=None):
    """``prefill_step(params, prompt) -> (logits, cache)``: ``prompt``
    the (B, T) tokens, or for an ``embeds`` frontend the (B, T,
    d_model) embeddings, moved to ``device``; ``logits`` the last
    position's (B, 1, vocab); the cache sized for ``s_max``."""
    device = resolve_device(device)
    kw = "embeds" if cfg.frontend == "embeds" else "tokens"

    def step(params, prompt):
        logits, cache, _ = prefill(params, cfg, s_max=s_max,
                                   cache_dtype=cache_dtype,
                                   **{kw: prompt.to(device)})
        return logits, cache

    return step


def make_decode_step(cfg: ModelConfig, device="cuda"):
    """``step(params, cache, pos, tok) -> (logits, cache)``: one token a
    sequence (``tok`` (B, 1), moved to ``device``; for an ``embeds``
    frontend a (B, 1, d_model) ``tok`` is an embedding) at absolute
    position ``pos`` against the cache, which is updated in place."""
    device = resolve_device(device)

    def step(params, cache, pos, tok):
        kw = ("embeds" if cfg.frontend == "embeds" and tok.ndim == 3
              else "tokens")
        return decode_step(params, cfg, cache, int(pos),
                           **{kw: tok.to(device)})

    return step
