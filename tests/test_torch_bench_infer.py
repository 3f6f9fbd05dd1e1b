"""The port's serving benchmark (``spherehand_torch.tools.bench_infer``) on
the CPU: its keys against the JAX package's ``tools/bench_infer.py``, read
from the sources, and its functions at B = 1 and 2 with a few calls, every
number finite and positive. Its times on the card are in PERF.md."""
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_tools import _dict_keys  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_TOOL = os.path.join(ROOT, "tools", "bench_infer.py")
PORT_TOOL = os.path.join(ROOT, "spherehand_torch", "tools", "bench_infer.py")
IDENTITY = {"gpu_name", "gpu_power_limit"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_keys_equal_the_jax_tools():
    """Per batch, the JAX tool's record keys; at the top, its keys and the
    card's name and power limit."""
    per_batch = _dict_keys(JAX_TOOL, {"main": "=rec"})
    assert per_batch == {"batch", "device_ms", "wall_ms_scanned", "crops_per_sec_device",
                         "crops_per_sec_wall"}
    assert _dict_keys(PORT_TOOL, {"measure_batch": "return"}) == per_batch
    top = _dict_keys(JAX_TOOL, {"main": "dumps"})
    assert top == {"metric", "results"}
    assert _dict_keys(PORT_TOOL, {"main": "dumps"}) == top | IDENTITY
    assert _dict_keys(os.path.join(ROOT, "spherehand_torch", "bench.py"),
                      {"gpu_identity": "return"}) == IDENTITY
    assert _dict_keys(PORT_TOOL, {"identity": "return"}) == IDENTITY


def test_crops_are_the_jax_tools():
    """The JAX tool's crops, from one RandomState(0) over the batches."""
    from spherehand_torch.tools.bench_infer import crops

    rng, want_rng = np.random.RandomState(0), np.random.RandomState(0)
    for b in (1, 8):
        got = crops(rng, b)
        want = np.full((b, 64, 64), 100.0, np.float32)
        want[:, 20:44, 20:44] = want_rng.uniform(20, 60, (b, 24, 24))
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_runs_on_the_cpu(capsys):
    """The tool's run at B = 1 and 2 (1 traced call, 2 calls a window, one
    window): the JAX tool's keys, every number finite and positive, one
    line a batch, and the CPU named as such."""
    from spherehand_torch.tools import bench_infer

    out = bench_infer.run([1, 2], "cpu", calls=1, iters=2, windows=1)
    assert [r["batch"] for r in out["results"]] == [1, 2]
    for rec in out["results"]:
        assert set(rec) == _dict_keys(JAX_TOOL, {"main": "=rec"})
        assert all(math.isfinite(v) and v > 0 for v in rec.values()), rec
        assert rec["crops_per_sec_device"] == round(rec["batch"] / rec["device_ms"] * 1e3)
    assert out["gpu_name"] == out["gpu_power_limit"] == "none (CPU run)"
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == ["B=    1", "B=    2"]
    json.dumps(out)  # serialisable: no tensor or None inside


def test_refuses_a_missing_card():
    """The default device is the card; without one the tool raises."""
    from spherehand_torch.tools import bench_infer

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench_infer.main(["1"])
