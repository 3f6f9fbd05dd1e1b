"""The port's tooling on the CPU: ``spherehand_torch.bench`` (its keys
against the JAX package's ``bench.py``, read from the sources; its
functions at a tiny size), ``spherehand_torch.doctor --cpu`` and
``spherehand_torch.kernel_parity --out``."""
import ast
import json
import math
import os
import re

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (many small CPU ops; the
    suite's workers share the cores); the count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dict_keys(path: str, functions: dict[str, str]) -> set[str]:
    """The string keys of the dict literals that ``functions`` (name ->
    "return", "dumps" or "=<variable>") return, pass to ``json.dumps`` or
    assign to the variable."""
    with open(path) as f:
        tree = ast.parse(f.read())
    keys = set()
    for fn in ast.walk(tree):
        if not (isinstance(fn, ast.FunctionDef) and fn.name in functions):
            continue
        for node in ast.walk(fn):
            if functions[fn.name] == "return" and isinstance(node, ast.Return):
                value = node.value
            elif (functions[fn.name] == "dumps" and isinstance(node, ast.Call)
                  and getattr(node.func, "attr", None) == "dumps"):
                value = node.args[0]
            elif (functions[fn.name].startswith("=") and isinstance(node, ast.Assign)
                  and any(getattr(t, "id", None) == functions[fn.name][1:]
                          for t in node.targets)):
                value = node.value
            else:
                continue
            if isinstance(value, ast.Dict):
                keys |= {k.value for k in value.keys if isinstance(k, ast.Constant)}
    return keys


def test_bench_keys_equal_the_jax_benchs():
    ref = _dict_keys(os.path.join(ROOT, "bench.py"),
                     {"main": "dumps", "dispatch_health": "return"})
    ours = _dict_keys(os.path.join(ROOT, "spherehand_torch", "bench.py"),
                      {"measure": "return", "dispatch_health": "return",
                       "gpu_identity": "return"})
    assert len(ref) == 15 and "train_epoch_bf16_steps_per_sec" in ref
    assert ours == ref | {"gpu_name", "gpu_power_limit"}


def test_bench_functions_run_on_the_cpu(tmp_path):
    """Each measurement at a tiny size on the CPU gives a finite positive
    rate; the health probe its two keys."""
    from spherehand_torch import bench
    from spherehand_torch.hand.assets import load_hand_model

    cpu = torch.device("cpu")
    lite = load_hand_model(device=cpu, lite=True)
    rates = [
        bench.render_fps(lite, 1, False, cpu, iters=1, windows=1, warmup=0),
        bench.combined_steps_per_sec(cpu, synt_batch=1, real_batch=1, iters=1, windows=1,
                                     warmup=0),
    ]
    data = bench.write_rendered_shards(str(tmp_path / "nyu"), cpu, train=2, test=1, lite=True)
    rates.append(bench.epoch_steps_per_sec(data, str(tmp_path / "runs"), cpu, steps=1,
                                           warmup=1, synt_batch=1, real_batch=1, mesh="lite"))
    assert all(math.isfinite(r) and r > 0 for r in rates), rates
    health = bench.dispatch_health(cpu)
    assert set(health) == {"health_dispatch_rtt_ms", "health_device_get_mbps"}
    assert all(v > 0 for v in health.values())


def test_doctor_cpu_passes_every_check(capsys):
    from spherehand_torch import doctor

    assert doctor.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    passed, total = map(int, re.search(r"^(\d+)/(\d+) checks passed$", out, re.M).groups())
    assert passed == total >= 8
    assert out.count("  PASS  ") == total and "FAIL" not in out
    assert "data-parallel group: 2 ranks, gloo cpu" in out


def test_kernel_parity_out_writes_its_line(tmp_path, monkeypatch, capsys):
    from spherehand_torch import kernel_parity

    monkeypatch.setattr(kernel_parity, "RASTER_BATCH", 1)
    monkeypatch.setattr(kernel_parity, "N", 4)
    monkeypatch.setattr(kernel_parity, "B", 1)
    out = tmp_path / "parity.json"
    assert kernel_parity.main(["--device", "cpu", "--out", str(out)]) == 0
    printed = capsys.readouterr().out.strip().splitlines()[0]
    with open(out) as f:
        written = f.read()
    assert written == printed + "\n"
    stats = json.loads(written)
    assert stats["device"] == "cpu" and math.isfinite(stats["stack_loss"])
