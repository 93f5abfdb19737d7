"""repro_torch.env: the pinned measurement environment.

``pin_for_benchmarks`` must leave TF32 off and the float32 matmul
precision at ``"highest"``; ``configure`` must apply each knob and hand
back what restores it; ``pinned`` and a tuned compile must give the
caller's settings back; ``describe`` must carry what the tuner's winner
key reads (``repro_torch.tune.store.tune_scope``).
"""
import pytest
import torch

from repro_torch import env
from repro_torch.tune import store


@pytest.fixture(autouse=True)
def _restore():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision(),
             torch.backends.cudnn.benchmark)
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    torch.set_float32_matmul_precision(saved[2])
    torch.backends.cudnn.benchmark = saved[3]


def test_pin_for_benchmarks_turns_tf32_off():
    env.configure(tf32=True, matmul_precision="high")
    torch.backends.cudnn.benchmark = True
    d = env.pin_for_benchmarks()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cudnn.benchmark is False
    assert d == env.describe()
    assert (d["tf32_matmul"], d["tf32_cudnn"], d["matmul_precision"],
            d["cudnn_benchmark"]) == (False, False, "highest", False)


@pytest.mark.parametrize("knobs", [
    {"tf32": True}, {"tf32": False}, {"matmul_precision": "medium"},
    {"tf32": False, "matmul_precision": "highest"}])
def test_configure_applies_each_knob_and_restores(knobs):
    env.pin_for_benchmarks()
    before = env.describe()
    prev = env.configure(**knobs)
    after = env.describe()
    if "matmul_precision" in knobs:
        assert after["matmul_precision"] == knobs["matmul_precision"]
    if "tf32" in knobs:
        assert (after["tf32_matmul"], after["tf32_cudnn"]) == \
            (knobs["tf32"],) * 2
    env.configure()                              # no knob, no change
    assert env.describe() == after
    env.restore(prev)
    assert env.describe() == before


def test_configure_restores_unequal_tf32_flags():
    """PyTorch's own default has TF32 off in matmuls and on in cuDNN;
    a bool-only ``tf32`` must still give both flags back."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    before = env.describe()
    prev = env.configure(tf32=True)
    assert env.describe()["tf32_matmul"] is True
    env.restore(prev)
    assert env.describe() == before


def test_pinned_pins_inside_and_restores_after():
    env.configure(tf32=True, matmul_precision="high")
    torch.backends.cudnn.benchmark = True
    before = env.describe()
    with pytest.raises(RuntimeError, match="inside"):
        with env.pinned() as d:
            assert d == env.describe()
            assert (d["tf32_matmul"], d["tf32_cudnn"], d["matmul_precision"],
                    d["cudnn_benchmark"]) == (False, False, "highest", False)
            raise RuntimeError("inside")
    assert env.describe() == before


def test_tuned_compile_leaves_the_callers_settings(monkeypatch):
    """The tuner measures pinned, then hands the user's settings back."""
    from repro_torch import runtime
    from repro_torch.gnn.models import ZooSpec
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.tune import measure

    seen = []
    real = measure.measure_plan

    def spy(*a, **kw):
        seen.append(env.describe())
        return real(*a, **kw)

    monkeypatch.setattr("repro_torch.tune.measure_plan", spy)
    monkeypatch.delenv("REPRO_PLAN_CACHE", raising=False)
    store.clear_tune_cache()
    env.configure(tf32=True, matmul_precision="high")
    torch.backends.cudnn.benchmark = True
    before = env.describe()
    ds = make_dataset("cora", seed=0, scale=0.05)
    spec = ZooSpec("gcn", ds.profile.feature_dim, 8, ds.profile.num_classes)
    exe = runtime.compile(spec, ds, device="cpu", plan="autotune",
                          tune_budget=2, tune_reps=1, max_shard_n=64)
    store.clear_tune_cache()
    assert exe.plan_source == "autotune" and seen
    for d in seen:
        assert (d["tf32_matmul"], d["tf32_cudnn"], d["matmul_precision"],
                d["cudnn_benchmark"]) == (False, False, "highest", False)
    assert env.describe() == before


def test_describe_has_what_the_tuner_scope_reads():
    d = env.describe("cpu")
    assert {"torch_version", "cuda_version", "device", "capability",
            "device_count", "tf32_matmul", "tf32_cudnn",
            "matmul_precision"} <= set(d)
    assert d["device"] == "cpu" and d["capability"] is None
    assert d["torch_version"] == torch.__version__
    assert d["cuda_version"] == torch.version.cuda
    scope = store.tune_scope("cuda", "cpu")
    for key in ("device", "torch_version", "cuda_version"):
        assert scope[key] == d[key]
