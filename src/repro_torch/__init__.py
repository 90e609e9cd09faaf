"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

Data-parallel TopK-SGD training of the ten assigned decoder LMs (dense,
MoE, Mamba-hybrid, xLSTM and ``embeds``-frontend models; serving them
with ``launch/serve.py``) with Gaussian-k, hist-k or trimmed-k — fixed-k or
with adaptive layer-wise density (``core/adaptk.py``), the ``bucketed``
pipeline, the ``allgather``, ``gtopk``, ``hierarchical`` and
``hier_gtopk`` wires over W workers (all in one process on one card, or
one per process over ``torch.distributed``), checkpoints — and the
unfused pipeline of the paper's Algorithm 1.  Every TPU kernel of
the reference is hand-written for ``sm_90a``:

* ``kernels/ef_fused/fused_moments.py``  K1, Triton: sum, sum of squares
  and abs-max of ``u = g + e``; for hist-k with its ``|u|`` histogram,
  CUDA C++ (``csrc/abs_histogram.cu``);
* ``kernels/ef_fused/tree_count.py`` + ``csrc/tree_count.cu``  K2,
  CUDA C++: counts of ``|u| > t_j`` over the refinement tree's
  thresholds;
* ``kernels/ef_fused/compact_residual.py`` + ``csrc/compact_residual.cu``
  K3, CUDA C++: threshold compaction into per-block staging rows, the
  residual write and the codec pair in one sweep (the stage and
  residual launches of the reference's GPU lowering beside it);
* ``kernels/moments``, ``kernels/gaussian_topk/{count_gt,
  threshold_compact}.py``, ``kernels/histk/hist.py``: the unfused
  pipeline's K4a-d, specialisations of the K1-K3 kernels.

Params are stored leaf for leaf the way the JAX package stores them
(``x @ W`` with ``W`` shaped ``(in, out)``, scan-stacked layers as one
``(L, ...)`` tensor) and flattened in key-sorted order (``tree.py``), so
the bucket layout, every per-leaf ``k`` and every selection agree with
the JAX reference.  Nothing here imports ``jax``.

Nothing is left to a later slice (``slices.py``).
"""
