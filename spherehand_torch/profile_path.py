"""Device-time breakdown of the port's main path on one GPU, by torch.profiler.

Each piece of the synthetic-render -> serve path runs ``CALLS`` times inside
one profiler window, after warm-up, and ``CALLS`` times more unprofiled for
its host time. For each piece it prints one JSON line, per call:

- ``host_ms``: wall clock, unprofiled, the device synchronised at both ends;
- ``launches``: device activities issued (kernel launches, copies, memsets),
  counted from the host-side runtime calls that issue them;
- ``recorded``: the share of those activities the tracer recorded. It
  loses a few now and then (up to one in ten in a window of ten
  single-kernel calls);
- ``device_ms``: the union of the recorded device activity intervals,
  divided by ``recorded`` so that a lost activity counts as the recorded
  mean (for a piece of one kernel: the mean time of its recorded launches);
- ``idle_share``: ``1 - device_ms / host_ms``, the share of the call in which
  the card has nothing to run;
- ``stream_syncs``: ``cudaStreamSynchronize`` calls, where the host waits
  for the device's queue (a pageable host-to-device copy ends in one);
- ``top``: the recorded device ops with the most time, as [name, ms, count].

Pieces, at B = 128 (the main path's batch) and 1024: the geometry front end
(``project_faces_planes``), each plain pre-pass, each raster kernel (from
the planes, at the same 128 x 128 samples), ``rasterize_fast`` (the raw
fast entry point from the planes), ``render_depth_64`` fast and exact,
``synthesize`` (fast, with noise) and ``PoseEstimator.predict`` with the
shipped weights; ``raster_fast`` alone at B = 32 on the whole 640 x 640
canvas. Then, at ``EngineConfig`` defaults (48 synthetic + 25 x
3 real, from the shipped weights): each sphere kernel alone (fused, min
depth, nearest distance) at the combined step's N = 225 images, the
mutual-projection loss forward and backward from the estimator's joints in
its unfused (per-field kernels) and fused form, and the train steps
``synt_step`` and ``combined_step``, each with its draws, and
``eval_step``. Last, the engine's combined step from NYU-format shards
(:data:`ENGINE_SAMPLES` rendered hands written with ``data.nyu.write_shard``,
initial weights): the batch from the host loader (``device_data`` off: a
gather thread, pinned memory, an asynchronous copy) or from the
device-resident split (on: an index copy and a gather on the card), the
step's draws and the step, as ``Engine`` runs them; and the same step on
one batch already on the card (``memory``, no feed). In turns (off, on,
memory, memory, on, off), since host time drifts within a process.
Then the single-card switches, each beside its baseline in turns (full,
lite, lite, full; f32, bf16, resample, resample, bf16, f32): the lite mesh's
``render_depth_64`` fast at B = 128 and ``synt_step``, and ``combined_step``
under ``bf16`` and ``depth_resample`` 3, from the shipped weights; and
``combined_term_diag`` once. ``--sections upsample``: the upsample
kernels alone (``ops/upsample.py``) at the hourglass's two shapes at
B = 128, beside ``F.interpolate``'s forward and backward on the same
tensors (the library yardstick). Last (``--sections determinism``),
``PoseEstimator.predict`` at B = 128 and the three train steps with the
evidence tools' deterministic settings (``utils.determinism``) off and on,
in turns (off, on, on, off); the process sets the cuBLAS workspace that
those settings need before CUDA starts.

Usage: python -m spherehand_torch.profile_path
       [--sections render train engine switches upsample determinism]

Needs a CUDA device. Exits non-zero without one, or when the profiler
records no device activity for a piece in ``TRACE_ATTEMPTS`` traces.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

CALLS = 10
TRACE_ATTEMPTS = 3
SEED = 0
BATCHES = (128, 1024)
CANVAS_BATCH = 32
TOP = 6
ENGINE_SAMPLES = 100
# device_data off and on, and the same step on one batch already on the
# card ("memory", no feed)
ENGINE_TURNS = ("off", "on", "memory", "memory", "on", "off")
DETERMINISM_TURNS = ("off", "on", "on", "off")
# Prefixes of the runtime calls that each put one activity on the device.
DEVICE_WORK_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
STREAM_SYNC_CALLS = ("cudaStreamSynchronize", "cuStreamSynchronize")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(_ROOT, "assets", "pretrained", "synthetic_params.npz")


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def device_events(prof):
    """Device activities, without the user annotations (such as
    ``Optimizer.step#Adam.step``) the profiler mirrors onto the device
    timeline: they span other activities and the gaps between them."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def issued_activities(prof, calls=DEVICE_WORK_CALLS) -> int:
    """Host-side runtime calls whose names start with one of ``calls``: by
    default those that each put one activity on the device."""
    return sum(1 for e in prof.events() if e.device_type != torch.autograd.DeviceType.CUDA
               and e.name.startswith(calls))


def host_ms(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def recorded_share(recorded: int, issued: int) -> float:
    """Share of the issued device activities that were recorded, at most 1
    (activities issued by calls outside ``DEVICE_WORK_CALLS`` count as
    recorded)."""
    return min(1.0, recorded / issued) if issued else 1.0


def profile_piece(fn, calls: int = CALLS) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    # The tracer now and then keeps no device activity of a whole session
    # (the work ran: its launches are recorded); such a trace is taken again.
    for _ in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        if events:
            break
    else:
        raise SystemExit("profile_path: the profiler recorded no device activity")
    issued = max(issued_activities(prof), len(events))
    recorded = recorded_share(len(events), issued)
    busy = union_us((e.time_range.start, e.time_range.end) for e in events) / 1e3 / calls / recorded
    per_name: dict = defaultdict(lambda: [0.0, 0])
    for e in events:
        per_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / calls
        per_name[e.name][1] += 1
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    wall = host_ms(fn, calls)
    return {
        "host_ms": wall,
        "device_ms": busy,
        "idle_share": 1.0 - busy / wall,
        "launches": issued / calls,
        "stream_syncs": issued_activities(prof, STREAM_SYNC_CALLS) / calls,
        "recorded": recorded,
        "top": [[name[:80], ms, n / calls] for name, (ms, n) in top],
    }


def main() -> int:
    import argparse

    if not torch.cuda.is_available():
        print("profile_path: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sections = ("render", "train", "engine", "switches", "upsample", "determinism")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sections", nargs="+", choices=sections, default=list(sections))
    args = ap.parse_args()
    if "determinism" in args.sections:
        from spherehand_torch.utils import determinism

        # cuBLAS reads it when its first handle is made
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = determinism.CUBLAS_WORKSPACE_CONFIG

    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.infer import PoseEstimator, load_params_npz
    from spherehand_torch.render.raster import bilinear_sample_positions

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}", flush=True)

    dev = torch.device("cuda")
    model = load_hand_model(device=dev)
    samples = torch.as_tensor(bilinear_sample_positions(64, 10), device=dev)
    estimator = PoseEstimator(load_params_npz(PARAMS), num_stacks=1, denoise=True,
                              precision="highest", device=dev)
    if "render" in args.sections:
        _profile_render_and_serve(model, samples, estimator)
    if "train" in args.sections:
        _profile_train_steps(model)
    if "engine" in args.sections:
        _profile_engine(model)
    if "switches" in args.sections:
        _profile_switches(model)
    if "upsample" in args.sections:
        _profile_upsample(dev)
    if "determinism" in args.sections:
        _profile_determinism(model, estimator)
    print(smi)
    return 0


def _profile_render_and_serve(model, samples, estimator) -> None:
    from spherehand_torch.data.sampler import sample_poses
    from spherehand_torch.data.synthesizer import draw_synthesis, synthesize
    from spherehand_torch.hand.kinematics import forward_kinematics
    from spherehand_torch.hand.skinning import apply_scale, project_faces_planes
    from spherehand_torch.render import raster_cuda
    from spherehand_torch.render.raster import render_depth_64

    dev = samples.device
    for batch in BATCHES:
        gen = torch.Generator(device=dev).manual_seed(SEED + batch)
        poses = sample_poses(gen, batch)
        draws = draw_synthesis(gen, batch)
        tr = apply_scale(forward_kinematics(model, poses), draws.scale_u, 0.1)
        rand_f = draws.rand_f
        planes = project_faces_planes(model, tr, 640.0, rand_f)
        dms_mm = synthesize(model, gen, poses).dms * 100.0
        pieces = {
            "planes": lambda: project_faces_planes(model, tr, 640.0, rand_f),
            "prepass_fast": lambda: raster_cuda.prepass_fast(planes=planes),
            "prepass_exact": lambda: raster_cuda.prepass_exact(planes=planes),
            "kernel_fast": lambda: raster_cuda.launch_raster_fast_pooled(
                planes, samples, samples, 100.0),
            "kernel_fast_raw": lambda: raster_cuda.launch_raster_fast(planes, samples, samples),
            "rasterize_fast": lambda: raster_cuda.rasterize_fast(samples, samples, planes=planes),
            "kernel_exact": lambda: raster_cuda.launch_raster_exact(
                planes, samples, samples, 640, 640),
            "render_fast": lambda: render_depth_64(model, tr, rand_f),
            "render_exact": lambda: render_depth_64(model, tr, rand_f, exact=True),
            "synthesize_fast": lambda: synthesize(model, gen, poses, add_noise=True),
            "predict": lambda: estimator.predict(dms_mm),
        }
        for name, fn in pieces.items():
            row = {"piece": name, "batch": batch, **profile_piece(fn)}
            print(json.dumps(row), flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    planes = project_faces_planes(model, forward_kinematics(model, sample_poses(gen, CANVAS_BATCH)),
                                  640.0)
    canvas = torch.arange(640, dtype=torch.float32, device=dev)
    row = {"piece": "kernel_fast_raw_canvas640", "batch": CANVAS_BATCH, **profile_piece(
        lambda: raster_cuda.launch_raster_fast(planes, canvas, canvas))}
    print(json.dumps(row), flush=True)


def _profile_train_steps(model) -> None:
    from spherehand_torch.convert import train_state_from_params
    from spherehand_torch.data.pseudo_real import render_multiview_batch, sphere_inputs
    from spherehand_torch.infer import load_params_npz
    from spherehand_torch.constants import Constants
    from spherehand_torch.losses.multiview import mutual_projection_loss
    from spherehand_torch.models.estimator import forward
    from spherehand_torch.render import sphere_cuda
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.steps import NUM_VIEWS, RealBatch, build_steps

    cfg = EngineConfig()
    fns = build_steps(cfg, hand=model)
    state = train_state_from_params(fns.init_state, load_params_npz(PARAMS))
    gen = torch.Generator(device=model.kp_radius.device).manual_seed(SEED)
    real = render_multiview_batch(model, gen, cfg.real_batch)
    batch = RealBatch(*real[:4])
    # the sphere kernels alone at the combined step's shapes (N = 25 x 3 x 3);
    # the distance field alone reads the gathered targets, as d2m_nearest does
    sc = sphere_cuda
    centers, target, _, _ = sphere_inputs(model, real)
    size = real.dms.shape[-1]
    inputs = {sc.BOTH: (target, NUM_VIEWS), sc.DEPTH: (None, 1),
              sc.DIST: (sc.gathered_target(target, centers.shape[0], NUM_VIEWS).contiguous(), 1)}
    for fields, (tgt, views) in inputs.items():
        args = (fields, centers, tgt, model.kp_radius, size, views)
        planes = sc.launch_fields(*args, residuals=True)
        k = sc.num_fields(fields)
        bwd = (fields, centers, tgt, views, [torch.ones_like(p) for p in planes[:k]], planes[k:])
        prefix = sc.LAUNCH_PREFIX[fields]
        pieces = {
            f"{prefix}_fwd": lambda a=args: sc.launch_fields(*a, residuals=True),
            f"{prefix}_primal": lambda a=args: sc.launch_fields(*a, residuals=False),
            f"{prefix}_bwd": lambda b=bwd: sc.launch_fields_bwd(*b),
        }
        for name, fn in pieces.items():
            row = {"piece": name, "batch": f"N={centers.shape[0]}", **profile_piece(fn)}
            print(json.dumps(row), flush=True)
    # the mutual-projection loss from the estimator's joints, forward and
    # backward to the joints: per-field kernels (unfused) and fused
    with torch.no_grad():
        joints = forward(state.network,
                         real_dms=batch.dms * Constants().depth_scale).real_xyz[-1]

    def mutual_projection(fused: bool):
        leaf = joints.clone().requires_grad_(True)
        loss, _ = mutual_projection_loss(batch.poses, batch.inv_poses, leaf, batch.dms,
                                         model.kp_radius, fused=fused)
        loss.backward()

    for name, fused in (("mutual_projection_unfused", False), ("mutual_projection_fused", True)):
        row = {"piece": name, "batch": f"{cfg.real_batch}x{NUM_VIEWS}",
               **profile_piece(lambda f=fused: mutual_projection(f))}
        print(json.dumps(row), flush=True)
    pieces = {
        "synt_step": lambda: fns.synt_step(state, cfg.lr, fns.draw(gen, real=False)),
        "combined_step": lambda: fns.combined_step(state, cfg.lr, fns.draw(gen), batch, True),
        "eval_step": lambda: fns.eval_step(state, fns.draw(gen, synt=False), batch),
    }
    for name, fn in pieces.items():
        row = {"piece": name, "batch": f"{cfg.synt_batch}+{cfg.real_batch}x{NUM_VIEWS}",
               **profile_piece(fn)}
        print(json.dumps(row), flush=True)


def _profile_engine(model) -> None:
    import tempfile

    from spherehand_torch.data.nyu import write_shard
    from spherehand_torch.data.pseudo_real import render_multiview_batch
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.engine import Engine

    dev = model.kp_radius.device
    with tempfile.TemporaryDirectory() as tmp:
        train = os.path.join(tmp, "nyu", "train")
        os.makedirs(train)
        real = render_multiview_batch(model, torch.Generator(device=dev).manual_seed(SEED),
                                      ENGINE_SAMPLES)
        write_shard(train, "mv_data_0",
                    *(x.cpu().numpy() for x in (real.dms, real.gt_joints, real.poses)))
        engines = {mode: Engine(EngineConfig(mode="Train", model_dir=os.path.join(tmp, "runs"),
                                             dataset_dir=os.path.join(tmp, "nyu"),
                                             device_data=mode), device=dev, hand=model)
                   for mode in ("off", "on")}

        def feed(engine):
            epoch = 0
            while True:
                for it, (_, batch) in enumerate(engine.batches(True, engine.cfg.real_batch,
                                                               epoch)):
                    yield epoch, it, batch
                epoch += 1

        feeds = {mode: feed(engine) for mode, engine in engines.items()}
        resident = next(feeds["on"])
        steps = {mode: (lambda f=feeds[mode], e=engine: e.combined_step(*next(f)))
                 for mode, engine in engines.items()}
        steps["memory"] = lambda: engines["on"].combined_step(*resident)
        for turn, mode in enumerate(ENGINE_TURNS):
            cfg = engines["off"].cfg
            row = {"piece": f"engine_combined_step_{mode}", "turn": turn,
                   "batch": f"{cfg.synt_batch}+{cfg.real_batch}x3",
                   **profile_piece(steps[mode])}
            print(json.dumps(row), flush=True)
        for batches in feeds.values():
            batches.close()


def _profile_switches(model) -> None:
    from spherehand_torch.convert import train_state_from_params
    from spherehand_torch.data.pseudo_real import render_multiview_batch
    from spherehand_torch.data.sampler import sample_poses
    from spherehand_torch.data.synthesizer import draw_synthesis
    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.hand.kinematics import forward_kinematics
    from spherehand_torch.hand.skinning import apply_scale
    from spherehand_torch.infer import load_params_npz
    from spherehand_torch.render.raster import render_depth_64
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.steps import NUM_VIEWS, RealBatch, build_steps

    dev = model.kp_radius.device
    lite = load_hand_model(device=dev, lite=True)
    meshes = {"full": model, "lite": lite}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    poses = sample_poses(gen, BATCHES[0])
    draws = draw_synthesis(gen, BATCHES[0])
    tr = {k: apply_scale(forward_kinematics(m, poses), draws.scale_u, 0.1)
          for k, m in meshes.items()}
    for turn, mesh in enumerate(("full", "lite", "lite", "full")):
        row = {"piece": f"render_fast_{mesh}", "batch": BATCHES[0], "turn": turn,
               **profile_piece(lambda: render_depth_64(meshes[mesh], tr[mesh], draws.rand_f))}
        print(json.dumps(row), flush=True)

    params = load_params_npz(PARAMS)
    cfgs = {"full": EngineConfig(), "lite": EngineConfig(mesh="lite"),
            "f32": EngineConfig(), "bf16": EngineConfig(bf16=True),
            "resample3": EngineConfig(depth_resample=3)}
    fns = {k: build_steps(c, hand=meshes[c.mesh]) for k, c in cfgs.items()}
    states = {k: train_state_from_params(f.init_state, params) for k, f in fns.items()}
    cfg = cfgs["f32"]
    batch = RealBatch(*render_multiview_batch(model, gen, cfg.real_batch)[:4])
    shape = f"{cfg.synt_batch}+{cfg.real_batch}x{NUM_VIEWS}"
    for turn, key in enumerate(("full", "lite", "lite", "full")):
        row = {"piece": f"synt_step_{key}", "batch": shape, "turn": turn, **profile_piece(
            lambda: fns[key].synt_step(states[key], cfg.lr, fns[key].draw(gen, real=False)))}
        print(json.dumps(row), flush=True)
    for turn, key in enumerate(("f32", "bf16", "resample3", "resample3", "bf16", "f32")):
        row = {"piece": f"combined_step_{key}", "batch": shape, "turn": turn, **profile_piece(
            lambda: fns[key].combined_step(states[key], cfg.lr, fns[key].draw(gen), batch, True))}
        print(json.dumps(row), flush=True)
    row = {"piece": "combined_term_diag", "batch": shape, **profile_piece(
        lambda: fns["f32"].combined_term_diag(states["f32"], fns["f32"].draw(gen), batch, True),
        calls=3)}
    print(json.dumps(row), flush=True)


def _profile_upsample(dev) -> None:
    """The upsample kernels alone at B = 128, (128, 256, 4, 4) and
    (128, 256, 8, 8), and F.interpolate's forward and backward on the same
    tensors."""
    import torch.nn.functional as F

    from spherehand_torch.ops import upsample

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for size in (4, 8):
        x = torch.randn(BATCHES[0], 256, size, size, generator=gen, device=dev)
        g = torch.randn(BATCHES[0], 256, 2 * size, 2 * size, generator=gen, device=dev)
        leaf = x.clone().requires_grad_(True)
        lib_out = F.interpolate(leaf, scale_factor=2, mode="bilinear", align_corners=False)
        pieces = {
            "upsample2x_fwd": lambda: upsample.launch_fwd(x),
            "upsample2x_bwd": lambda: upsample.launch_bwd(g),
            "interpolate_fwd": lambda: F.interpolate(x, scale_factor=2, mode="bilinear",
                                                     align_corners=False),
            "interpolate_bwd": lambda: torch.autograd.grad(lib_out, leaf, g, retain_graph=True),
        }
        for name, fn in pieces.items():
            row = {"piece": name, "batch": f"{BATCHES[0]}x256x{size}x{size}", **profile_piece(fn)}
            print(json.dumps(row), flush=True)

def _profile_determinism(model, estimator) -> None:
    """predict at B = 128 and the three steps with the deterministic
    settings off and on, in turns."""
    from spherehand_torch.convert import train_state_from_params
    from spherehand_torch.data.pseudo_real import render_multiview_batch
    from spherehand_torch.data.sampler import sample_poses
    from spherehand_torch.data.synthesizer import synthesize
    from spherehand_torch.infer import load_params_npz
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.steps import RealBatch, build_steps
    from spherehand_torch.utils import determinism

    dev = model.kp_radius.device
    cfg = EngineConfig()
    fns = build_steps(cfg, hand=model)
    state = train_state_from_params(fns.init_state, load_params_npz(PARAMS))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = RealBatch(*render_multiview_batch(model, gen, cfg.real_batch)[:4])
    dms_mm = synthesize(model, gen, sample_poses(gen, BATCHES[0])).dms * 100.0
    pieces = {
        "predict": (BATCHES[0], lambda: estimator.predict(dms_mm)),
        "synt_step": (cfg.synt_batch,
                      lambda: fns.synt_step(state, cfg.lr, fns.draw(gen, real=False))),
        "combined_step": (f"{cfg.synt_batch}+{cfg.real_batch}x3",
                          lambda: fns.combined_step(state, cfg.lr, fns.draw(gen), batch, True)),
        "eval_step": (f"{cfg.real_batch}x3",
                      lambda: fns.eval_step(state, fns.draw(gen, synt=False), batch)),
    }
    for turn in DETERMINISM_TURNS:
        saved = determinism.enable() if turn == "on" else None
        try:
            for name, (size, fn) in pieces.items():
                row = {"piece": f"{name}_deterministic_{turn}", "batch": size, **profile_piece(fn)}
                print(json.dumps(row), flush=True)
        finally:
            if saved is not None:
                determinism.restore(saved)


if __name__ == "__main__":
    sys.exit(main())

