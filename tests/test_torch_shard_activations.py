"""``shard_activations`` under tensor parallelism (``models/model.py
_forward``, ``dist/tensor_parallel.split_to_model``) on the CPU, in 2
gloo processes (``tests/_torch_tp_pg.py``) at ``1x2``.

* On the shards of the 2-layer dense config and of the smoke variants
  of the MoE, Mamba-hybrid and xLSTM archs, ``loss_fn(remat=True)``
  with the option against it without: the loss, the MoE aux loss and
  every gradient bitwise (the split and the gather are exact copies);
  each period's checkpoint input is ``(B, T, d_model / 2)``, saved in a
  storage of its own size.
* The trainer (3 steps, remat on) with the option against it without:
  the losses and the gathered checkpoint (params, momentum, residuals)
  bitwise.
* ``split_to_model`` alone: a contiguous copy of the rank's slice, and
  ``axis=None`` the identity.
"""
import json

import numpy as np
import torch

from _torch_tp_pg import launch
from repro_torch.dist.tensor_parallel import split_to_model

torch.set_num_threads(2)

COMMON = ["--arch", "llama3.2-1b", "--compressor", "gaussiank", "--ratio",
          "0.02", "--density-policy", "none", "--steps", "3", "--batch", "4",
          "--seq", "16", "--log-every", "1", "--mesh", "1x2"]
ARCHS = ["deepseek-moe-16b", "jamba-1.5-large-398b", "xlstm-125m"]


def test_shard_activations_is_bitwise_and_keeps_the_slice(tmp_path):
    cases = [{"name": "actshard", "argv": ["1x2", ARCHS]},
             {"name": "off", "argv": COMMON},
             {"name": "on", "argv": COMMON, "shard_activations": True}]
    launch(tmp_path, 2, cases, timeout=600)
    recs = [json.loads((tmp_path / f"{t}.json").read_text())
            for t in ("on", "off")]
    assert [r["loss"] for r in recs[0]] == [r["loss"] for r in recs[1]]
    on, off = (np.load(tmp_path / f"{t}.npz") for t in ("on", "off"))
    assert sorted(on.files) == sorted(off.files)
    for key in on.files:
        np.testing.assert_array_equal(on[key], off[key], err_msg=key)


class _Axis:
    rank, size = 1, 4

    def gather(self, t):
        return torch.stack([t + r for r in range(self.size)])


def test_split_to_model_copies_its_slice():
    x = torch.arange(24.0).reshape(2, 12).requires_grad_(True)
    y = split_to_model(x, _Axis())
    assert y.shape == (2, 3) and y.is_contiguous()
    assert y.untyped_storage().nbytes() == 6 * 4
    assert torch.equal(y, x[:, 3:6])
    (g,) = torch.autograd.grad(y, x, torch.ones_like(y))
    # the backward concatenates every rank's gradient slice in rank order
    assert torch.equal(g, torch.cat([torch.ones(2, 3) + r
                                     for r in range(4)], dim=-1))
    assert split_to_model(x, None) is x
