"""The yardstick's operation and byte counts against hand counts: the
default reference family's (as a configuration that names no family
gets them) and the whole step's."""
import pytest

pytest.importorskip("torch")

import _bench_tiny  # noqa: E402,F401
from bench.harness.spec import DEFAULT_FAMILY, load_family  # noqa: E402
from bench.work.formulas import (DocStep, launch_model_flops,  # noqa: E402
                                 least_seconds)

FAM = load_family(DEFAULT_FAMILY)
Shape, active_params = FAM.Shape, FAM.active_params


def _spec(sh):
    return {"num_heads": sh.heads, "num_kv_heads": sh.kv_heads,
            "head_dim": sh.head_dim, "num_layers": sh.layers,
            "dtype": "bfloat16"}


def extend_call(sh, docs):
    return FAM.extend_call(_spec(sh), docs)


def decode_call(sh, kvs):
    return FAM.decode_call(_spec(sh), kvs)


@pytest.mark.parametrize("sh", [Shape(16, 8, 128, 28), Shape(12, 2, 128, 1)])
def test_bench_formulas_extend_hand_count(sh):
    # 3 new tokens after 2 cached: queries see 3, 4, 5 keys
    f, b = extend_call(sh, [(2, 3)])
    assert f == 4 * sh.heads * sh.head_dim * (3 + 4 + 5)
    assert b == 2 * (2 * 3 * sh.heads * sh.head_dim
                     + 2 * 5 * sh.kv_heads * sh.head_dim)
    # two documents add up; a document with nothing new adds nothing
    f2, b2 = extend_call(sh, [(2, 3), (0, 1), (7, 0)])
    assert f2 == f + 4 * sh.heads * sh.head_dim * 1
    assert b2 == b + 2 * (2 * sh.heads * sh.head_dim
                          + 2 * sh.kv_heads * sh.head_dim)


@pytest.mark.parametrize("sh", [Shape(16, 8, 128, 28), Shape(32, 8, 128, 16)])
def test_bench_formulas_decode_hand_count(sh):
    f, b = decode_call(sh, [10, 1])
    assert f == 4 * sh.heads * sh.head_dim * 11
    assert b == 2 * (2 * 2 * sh.heads * sh.head_dim
                     + 2 * 11 * sh.kv_heads * sh.head_dim)
    assert least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert least_seconds(0.0, 3.35e12) == pytest.approx(1.0)


def test_bench_formulas_step():
    dense = {"d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4,
             "d_ff": 16, "num_layers": 3, "vocab_size": 100,
             "dtype": "bfloat16"}
    attn = 8 * 2 * 4 * 2 + 8 * 1 * 4 * 2
    assert active_params(dense) == 3 * (attn + 3 * 8 * 16)
    moe = dict(dense, moe={"num_experts": 4, "top_k": 2})
    assert active_params(moe) == 3 * (attn + 2 * 3 * 8 * 16 + 8 * 4)
    sh = Shape(2, 1, 4, 3)
    assert FAM.attention_layers(dense) == 3
    fl = launch_model_flops(FAM, dense, [DocStep(cached=0, new=2, kv=2,
                                                 op_len=1)])
    f_ext, _ = extend_call(sh, [(0, 2)])
    f_dec, _ = decode_call(sh, [3])
    assert fl == 3 * 2 * active_params(dense) + 3 * (f_ext + f_dec) \
        + 2 * (2 * 8 * 100)
