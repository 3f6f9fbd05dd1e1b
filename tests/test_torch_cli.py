"""The port's CLI (``python -m spherehand_torch``) against the JAX package's:
the same flags and defaults, every field mapped, the single-card switches
run, and the rank plan of data parallelism (one rank per card, the
launcher's group joined, ``--temporal``'s largest divisor)."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spherehand_tpu.train import cli as jcli  # noqa: E402
from spherehand_torch.train import cli  # noqa: E402
from spherehand_torch.parallel.mesh import RankPlan, rank_plan, temporal_message  # noqa: E402
from spherehand_torch.train.config import EngineConfig  # noqa: E402
from spherehand_torch.train.engine import Engine  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FLAG_SETS = [
    [],
    ["--mode", "Train", "--synthesize", "--temporal", "--epoch", "3", "--lr", "3e-4"],
    ["--mv_projection", "--mv_consistency", "--collision", "--bone_length", "--prior",
     "--num_stacks", "2", "--tag", "x_", "--seed", "7", "--no_data_parallel"],
    ["--mode", "Test", "--initial_model", "runs/a/model_3.pt", "--eval_batch", "4",
     "--eval_precision", "highest", "--device_data", "off", "--dataset_dir", "d"],
    ["--restore_from_model", "run1", "--restore_from_epoch", "5", "--real_batch", "5",
     "--synt_batch", "6", "--steps_per_call", "4", "--model_dir", "m"],
    ["--bf16", "--mesh", "lite", "--depth_resample", "3", "--device_data", "on"],
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: these tests run many small
    CPU ops, which a parallel region slows down when the suite's workers
    share the cores; the previous count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("argv", FLAG_SETS)
def test_flags_and_defaults_equal_jax(argv):
    ours = vars(cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert ours.pop("device") == "cpu"
    assert ours == vars(jcli.build_parser().parse_args(argv))
    assert cli.build_parser().parse_args(argv).device == "cuda"


@pytest.mark.parametrize("argv", FLAG_SETS)
def test_config_from_args_maps_every_field(argv):
    ours = cli.config_from_args(cli.build_parser().parse_args(argv))
    ref = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_every_flag_reaches_its_field():
    """Each flag, set away from its default, moves the configuration field
    of its name (``--no_data_parallel``: ``data_parallel``)."""
    parser = cli.build_parser()
    base = dataclasses.asdict(cli.config_from_args(parser.parse_args([])))
    assert base == dataclasses.asdict(EngineConfig())
    values = {"mode": "Train", "mesh": "lite", "device_data": "on", "eval_precision": "highest"}
    for action in parser._actions:
        if action.dest in ("help", "device"):
            continue
        if action.nargs == 0:
            argv = [action.option_strings[0]]
        else:
            value = values.get(action.dest, {int: "7", float: "0.5", str: "s"}[action.type or str])
            argv = [action.option_strings[0], value]
        field = "data_parallel" if action.dest == "no_data_parallel" else action.dest
        got = dataclasses.asdict(cli.config_from_args(parser.parse_args(argv)))
        assert {k for k in got if got[k] != base[k]} == {field}, argv


@pytest.mark.parametrize("argv,item", [
    (["--bf16"], "Queue 1 item 4"),
    (["--mesh", "lite"], "Queue 1 item 4"),
    (["--depth_resample", "5"], "Queue 1 item 4"),
])
def test_queued_switches_raise(argv, item, tmp_path):
    """The switches once queued under ``item`` are ported and no longer
    raise: each flag, parsed by ``config_from_args``, trains one synthetic
    epoch on the CPU through the
    ``Engine`` (``synt_iters_per_epoch`` 1 and synt 2, set on the parsed
    configuration: the CLI has no flag for them), with finite metrics and
    the switch in effect."""
    args = cli.build_parser().parse_args(
        ["--mode", "Train", "--device", "cpu", "--model_dir", str(tmp_path)] + argv)
    cfg = cli.config_from_args(args)
    cfg = dataclasses.replace(cfg, synt_iters_per_epoch=1, synt_batch=2, real_batch=1)
    engine = Engine(cfg, device=args.device)
    engine._epoch_synt(0)
    with open(engine.metrics_file) as f:
        records = [json.loads(line) for line in f]
    assert records and all(np.isfinite(v) for r in records for v in r.values()
                           if isinstance(v, float)), (item, records)
    assert engine.hand.num_faces == (1700 if cfg.mesh == "lite" else 3382)
    assert engine.state.network.dtype == (torch.bfloat16 if cfg.bf16 else torch.float32)
    assert all(p.dtype == torch.float32 for p in engine.state.network.parameters())
    draws = engine.step_draws(0, 0, real=False)
    assert (draws.resample_synt is not None) == (cfg.depth_resample != 0)
    assert engine.state.step == 1


def test_rank_plan_places_one_rank_per_card():
    """``rank_plan``: 2 cards with ``data_parallel`` give 2 spawned ranks,
    ``--no_data_parallel`` one; one card or the CPU one; a launcher's
    environment is joined as it is (and refused with
    ``--no_data_parallel``); ``--temporal`` takes the largest rank count
    dividing every batch, with the JAX engine's message."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    parse = cli.build_parser().parse_args
    on = cli.config_from_args(parse([]))
    off = cli.config_from_args(parse(["--no_data_parallel"]))
    assert rank_plan(on, cuda, 2, {}) == RankPlan(2, "spawn")
    assert rank_plan(off, cuda, 2, {}) == RankPlan(1, "single")
    assert rank_plan(on, cuda, 1, {}) == RankPlan(1, "single")
    assert rank_plan(on, cpu, 0, {}) == RankPlan(1, "single")
    env = {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1"}
    assert rank_plan(on, cuda, 1, env) == RankPlan(2, "join")
    assert rank_plan(on, cpu, 0, env) == RankPlan(2, "join")
    assert rank_plan(on, cuda, 4, {"WORLD_SIZE": "1"}) == RankPlan(1, "single")
    with pytest.raises(ValueError, match="no_data_parallel"):
        rank_plan(off, cuda, 2, env)
    temporal = cli.config_from_args(parse(["--temporal"]))  # 25 / 48 / 8: one rank
    assert rank_plan(temporal, cuda, 8, {}) == RankPlan(1, "single", temporal_message(1, 8))
    even = dataclasses.replace(temporal, real_batch=24, synt_batch=48, eval_batch=6)
    assert rank_plan(even, cuda, 8, {}) == RankPlan(6, "spawn", temporal_message(6, 8))
    assert rank_plan(even, cuda, 3, {}) == RankPlan(3, "spawn")
    assert temporal_message(6, 8) == ("[engine] --temporal: data-parallel over 6/8 devices "
                                      "(padding is incompatible with the consecutive-frame "
                                      "loss)")
    with pytest.raises(ValueError, match="does not divide"):
        rank_plan(temporal, cuda, 1, env)


def test_module_entry_point(tmp_path):
    """``python -m spherehand_torch``: Test mode needs a model; without a
    GPU the default device raises rather than running on the CPU."""
    run = subprocess.run([sys.executable, "-m", "spherehand_torch", "--mode", "Test"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and "requires --initial_model" in run.stderr
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--mode", "Train", "--model_dir", str(tmp_path)])
