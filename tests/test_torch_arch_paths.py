"""The bucket layouts of the archs ``chip_smoke.py`` phase 11 and
``--tensor-parallel-cards`` train at full width, at the depth and model
axis they run there: the port's ``build_layout`` on its meta params
against the reference's ``repro.dist.layout.build_layout`` on
``jax.eval_shape`` of ``repro.models.init_params``, field for field, each
bucket below 2**31 columns (its int32 wire indices), and command-r-35b,
whose bucket fits int32 only with its rows cut four ways, refused by the
port at a model axis of 1 and 2; and the dry run's count of each
one-card train step (``launch.step_cost.count_temp_bytes``) with the
gradients' pack into the bucket, whose columns are the reference
layout's.  Shapes only: no weight is drawn."""
import dataclasses

import jax
import pytest

from repro.configs import get_config as j_get_config
from repro.core import adaptk as ja
from repro.core.compressors import get_compressor as j_get
from repro.dist import layout as jl
from repro.models import init_params as j_init
from repro_torch.configs import get_config
from repro_torch.core.compressors import get_compressor
from repro_torch.dist import layout as tl
from repro_torch.launch import step_cost, train
from repro_torch.models import init_params

RATIO = 0.001
INT32 = 2 ** 31

# (arch, num_layers kept, model axis M, d_row_total, the largest leaf, its
# name): the depths of phase 11b and of the four-card run
PATHS = [
    ("stablelm-1.6b", 24, 1, 1_644_267_520, 276_824_064,
     "stack/0/ffn/w_down"),
    ("gemma3-4b", 6, 1, 1_908_441_600, 671_088_640, "embed"),
    ("phi3.5-moe-42b-a6.6b", 1, 1, 1_562_980_352, 419_430_400,
     "stack/0/ffn/w_down"),
    ("llava-next-34b", 2, 1, 2_033_224_704, 458_752_000, "embed"),
    ("command-r-35b", 4, 4, 1_753_237_504, 2_097_152_000, "embed"),
]
# command-r-35b at 4 layers with its rows cut fewer ways
REFUSED = [("command-r-35b", 4, 1), ("command-r-35b", 4, 2)]
FIELDS = ("name", "shape", "dtype", "size", "d_pad", "d_row", "row_off",
          "k_row", "k_cap", "cap_off", "k_lo", "k_hi", "salt")


def _cfgs(arch, layers):
    return (dataclasses.replace(get_config(arch), num_layers=layers)
            .validate(),
            dataclasses.replace(j_get_config(arch), num_layers=layers)
            .validate())


def _policies(arch, cfg):
    """The train CLI's own policy for ``arch`` (no ``--density-policy``:
    the config's default for a dynamic-k compressor) and the reference's
    with the same fields, or ``(None, None)``."""
    pol, name = train.density_policy_of(train.parse_args(["--arch", arch]),
                                        cfg)
    if pol is None:
        return None, None
    fields = pol._asdict()
    return pol, ja.make_policy(fields.pop("policy"), **fields)


@pytest.mark.parametrize("arch,layers,M,expect", [
    pytest.param(a, n, m, (d, big, leaf), id=f"{a}-{n}L-M{m}")
    for a, n, m, d, big, leaf in PATHS] + [
    pytest.param(a, n, m, None, id=f"{a}-{n}L-M{m}-refused")
    for a, n, m in REFUSED])
def test_card_path_layout_matches_reference(arch, layers, M, expect):
    cfg, jcfg = _cfgs(arch, layers)
    pol, jpol = _policies(arch, cfg)
    meta = init_params(cfg, 0, "meta")
    if expect is None:
        with pytest.raises(ValueError, match="overflows the int32"):
            tl.build_layout(meta, M, RATIO, get_compressor("gaussiank"),
                            density_policy=pol)
        return
    d_total, biggest, name = expect
    lay = tl.build_layout(meta, M, RATIO, get_compressor("gaussiank"),
                          density_policy=pol)
    jshapes = jax.eval_shape(lambda: j_init(jcfg, jax.random.PRNGKey(0)))
    jlay = jl.build_layout(jshapes, M, RATIO, j_get("gaussiank"),
                           density_policy=jpol)
    assert lay.adaptive == jlay.adaptive == (arch == "phi3.5-moe-42b-a6.6b")
    if lay.adaptive:
        assert pol.policy == "absmax"
    assert len(lay.segments) == len(jlay.segments)
    for s, js in zip(lay.segments, jlay.segments):
        for f in FIELDS:
            assert getattr(s, f) == getattr(js, f), (s.name, f)
    assert (lay.model_size, lay.d_row_total, lay.k_cap_total) == (
        jlay.model_size, jlay.d_row_total, jlay.k_cap_total)
    assert lay.d_row_total == d_total < INT32
    sizes = {s.name: s.size for s in lay.segments}
    assert max(sizes.values()) == sizes[name] == biggest
    rows = {s.name: s.d_row for s in lay.segments}
    assert rows[name] == biggest // M


@pytest.mark.parametrize("arch,layers,B,T,pack", [
    ("stablelm-1.6b", 24, 8, 128, True),
    ("gemma3-4b", 6, 2, 2048, False),
    ("phi3.5-moe-42b-a6.6b", 1, 8, 128, True),
    ("llava-next-34b", 2, 8, 128, True),
])
def test_train_count_holds_the_pack(arch, layers, B, T, pack):
    """A train step's count holds the pack: every f32 gradient alive
    beside the bucket they are packed into (``d_row_total`` f32 columns,
    the reference layout's).  At 8 x 128 the pack is the count; at
    gemma3-4b's 2 x 2048 the head's logits and activations stay above
    it."""
    cfg, jcfg = _cfgs(arch, layers)
    jshapes = jax.eval_shape(lambda: j_init(jcfg, jax.random.PRNGKey(0)))
    jlay = jl.build_layout(jshapes, 1, RATIO, j_get("gaussiank"))
    grads = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(jshapes))
    got = step_cost.count_temp_bytes(cfg, B, T, remat=True)["temp_bytes"]
    packed = grads + 4 * jlay.d_row_total
    assert got == packed if pack else got > packed
