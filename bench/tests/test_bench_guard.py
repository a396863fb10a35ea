"""The import guard compares whole top-level module names."""
import pytest

pytest.importorskip("torch")

import _bench_tiny  # noqa: E402,F401
from bench.harness import guard  # noqa: E402


def test_bench_guard_names():
    assert guard.forbidden_modules(["repro_torch.serving", "repro_torch",
                                    "jaxtyping", "reprox"]) == []
    assert guard.forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                                    "flax.linen", "torch"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro.core"]


def test_bench_guard_check_raises_naming_the_module():
    guard.check("clean", ["torch", "repro_torch.serving.engine", "numpy"])
    with pytest.raises(ImportError, match="repro.core"):
        guard.check("test", ["torch", "repro.core", "repro_torch"])
    with pytest.raises(ImportError, match="jax.numpy"):
        guard.check("test", ["jax.numpy"])
