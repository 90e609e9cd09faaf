"""The step's model FLOPs over the time of the traced run's unprofiled
steps, as a share of the cards' bf16 peak (989 TFLOP/s each): ``6·N``
a token, N the active parameters without the input embedding (routed
experts at top-k over their number), plus attention's ``12·L·T·d_attn``;
no recompute."""
from perfbench.bench.flops import PEAK_BF16_FLOPS, model_flops


def read(run):
    if not run.gpu:
        return None
    secs = [s for s, p in zip(run.step_s, run.profiled) if not p]
    if not secs:
        return None
    flops = model_flops(run.model, run.tokens_per_step,
                        run.traffic["seq_len"]) * len(secs)
    return 100.0 * flops / sum(secs) / (PEAK_BF16_FLOPS * run.cell.chips)
