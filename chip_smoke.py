#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (spherehand_torch) on one NVIDIA GPU.

Phases, each fatal on failure:
  1. versions, device name, power limit;
  2. build the CUDA rasterizers and sphere kernels from spherehand_torch/csrc
     with nvcc, one process per source, started together;
  3. each kernel against its plain PyTorch version on the card: full mesh at
     B = 8 sampler poses plus the adversarial face sets; fast against exact
     by the fast-mode contract (phase 5 repeats the kernel checks at the
     main path's B = 128);
  4. the main path: B = 128 sampler poses -> synthesize(add_noise=True), in
     the fast (default) and the exact raster mode -> PoseEstimator with the
     shipped weights (precision "highest") -> mean joint error under 25 mm,
     the same crops served on the CPU agree within 1e-2 mm, and both
     kernels' launch counters were raised by that run;
  5. CUDA-event timings (median of 20 calls after warm-up) at B = 128 and
     1024: render_depth_64 fast and exact, each kernel alone, each plain
     version, and PoseEstimator.predict at B = 128;
  6. the three sphere kernels against their plain versions on the card at
     N = 225 (the projected sphere centres of a rendered 25-hand, 3-view
     batch against its depth maps) and on an adversarial set (exact ties,
     a sphere centred on a pixel, all-background targets): forward fields
     and argmins identical, weights within 1 ulp, backward within 1e-5
     relative and bit-identical across two runs, the lowest-j tie rule;
  7. the training path at full width (EngineConfig defaults: 48 synthetic
     + 25 x 3 real, one stack, Adam lr 1e-3): render the real batch (exact
     raster), 3 synt_steps, 3 combined_steps (is_mv True, True, False) and
     1 eval_step from the shipped weights; every metric finite, the
     parameters moved, all five kernels launched by this phase;
  8. one combined_grads on the card and on the CPU at the geometry of
     tests/goldens/grad_parity_ab.npz (8 synthetic + 4 x 3 real, real batch
     read from that file) with the same draws and TF32 off: loss terms
     within 1e-3 relative, per-tensor gradient norms within 5 %;
  9. CUDA-event medians: each sphere kernel and plain version at N = 225,
     synt_step and combined_step (draws included) and eval_step.

The last three lines of standard output are the kernels JSON line, the card's
name and power limit, and the result line. Exits non-zero without a GPU.

Usage: python3 chip_smoke.py [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PARAMS = os.path.join(ROOT, "assets", "pretrained", "synthetic_params.npz")

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and float32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float32 words a face the exact rule needs: the record's 24 fields less the
# padding field 23 (the kernel reads xlo/xhi from the box's x range instead
# of fields 2 and 5, so they are counted once). The box's y range only
# speeds the skip and is not counted.
EXACT_FIELDS_NEEDED = 23
# Operations one face-sample test costs, counted from the kernel source
# (csrc/raster.cu): fast = box test 4 + w0, w1, q 4 each + w2 2 + 3 compares
# + reciprocal + min; exact = box/span tests 4 + edges 7 + span bounds 6 +
# 3 barycentrics 4 each + clamps 6 + w_sum 2 + 1/z sum 5 + divisions 2 +
# isnan, w_sum test, min 3.
FAST_OPS_PER_TEST = 22
EXACT_OPS_PER_TEST = 47
MAIN_BATCH = 128
BATCHES = (MAIN_BATCH, 1024)
REPS = 20
# Kernel vs plain version, max |diff| in mm. Both kernels round operation
# for operation like their plain versions, so any difference is a fault.
FAST_MAX_ERR = 1e-3
EXACT_MAX_ERR = 1e-3
DEVICE = "cuda"
GRAD_PARITY = os.path.join(ROOT, "tests", "goldens", "grad_parity_ab.npz")
# Operations per pixel-sphere update, counted from csrc/sphere.cu: depth
# 2 sub, 2 mul, 2 sub, compare, max, sqrt, sub, select, compare = 12, plus
# 3 selects of the argmin update; distance p.c 3 mul + 2 add, 2 p.c, sub,
# add, max, sqrt, sub, abs, select, compare = 14, plus 4 selects. The
# primal kernel keeps only the two minima (no argmin, sq, raw, r selects).
SPHERE_FWD_OPS = 33
SPHERE_PRIMAL_OPS = 28
# Backward: per pixel 9 to form the weighted terms + 8 adds into its
# winning spheres' sums; per (image, sphere) 10 to combine the sums.
SPHERE_BWD_OPS_PIXEL = 17
SPHERE_BWD_OPS_SPHERE = 10
# GPU vs CPU combined_grads (TF32 off on the card): loss terms within 1e-3
# relative; per-tensor gradient norms within 5 %, the bound
# tests/test_grad_parity.py puts on float32 accumulation order amplified
# through GroupNorm and the mutual-projection silhouettes.
GPU_CPU_TERM_REL = 1e-3
GPU_CPU_GNORM_REL = 5e-2
TRAIN_STEPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def face_sample_tests(box, sample_x, sample_y) -> int:
    """Face-sample pairs a binned render must test: for every kept face, the
    samples inside its box."""
    sx, sy = sample_x.contiguous(), sample_y.contiguous()
    nx = (torch.searchsorted(sx, box[..., 1].contiguous(), right=True)
          - torch.searchsorted(sx, box[..., 0].contiguous(), right=False)).clamp(min=0)
    ny = (torch.searchsorted(sy, box[..., 3].contiguous(), right=True)
          - torch.searchsorted(sy, box[..., 2].contiguous(), right=False)).clamp(min=0)
    return int((nx * ny).sum())


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from spherehand_torch import cuda_build
    from spherehand_torch.convert import train_state_from_params
    from spherehand_torch.data.pseudo_real import render_multiview_batch
    from spherehand_torch.data.sampler import sample_poses
    from spherehand_torch.data.synthesizer import draw_synthesis, synthesize, synthesize_from_draws
    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.hand.kinematics import forward_kinematics
    from spherehand_torch.hand.skinning import apply_scale, project_faces_planes
    from spherehand_torch.infer import PoseEstimator, float32_precision, load_params_npz
    from spherehand_torch.losses.multiview import apply_rigid, mutual_transforms
    from spherehand_torch.render import contracts, raster_cuda, sphere_cuda
    from spherehand_torch.render.adversarial import adversarial_cases, sphere_adversarial_case
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.steps import RealBatch, build_steps
    from spherehand_torch.render.raster import (
        bilinear_sample_positions,
        pool_2x2,
        rasterize_depth,
        render_depth_64,
    )

    dev = torch.device(DEVICE)

    # ---------------------------------------------------------------- 1
    smi = nvidia_smi_line()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} | {smi}")

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    built = cuda_build.build_all(["raster", "sphere"])
    log(f"[2] built {[os.path.relpath(p, ROOT) for p, _ in built.values()]} "
        f"in {time.perf_counter() - t0:.2f} s")
    for _, ptxas in built.values():
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"    {line.strip()}")

    model = load_hand_model(device=dev)
    samples = torch.as_tensor(bilinear_sample_positions(64, 10), device=dev)

    def hand_planes(batch: int, seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        poses = sample_poses(gen, batch)
        draws = draw_synthesis(gen, batch)
        tr = apply_scale(forward_kinematics(model, poses), draws.scale_u, 0.1)
        return tr, draws.rand_f, project_faces_planes(model, tr, 640.0, draws.rand_f)

    def face_vertices(planes):
        u, v, z = planes
        return torch.stack([u, v, z], dim=-1).reshape(u.shape[0], -1, 3, 3)

    def compare(fv, s, size, tag):
        """Both kernels vs their plain versions on one geometry; returns the
        kernels' max |diff| to the plain versions."""
        rec_e, box_e = raster_cuda.prepass_exact(fv, width=size)
        k_exact = raster_cuda.launch_raster_exact(rec_e, box_e, s, s, size)
        p_exact = rasterize_depth(fv, s, s, size, size)
        st = contracts.exact_stats(k_exact, p_exact)
        if not (contracts.exact_ok(st) and st["max_abs_err"] <= EXACT_MAX_ERR):
            fail(f"{tag}: exact kernel vs plain exact {st}")
        rec_f, box_f = raster_cuda.prepass_fast(fv)
        k_fast = raster_cuda.launch_raster_fast_pooled(rec_f, box_f, s, s, 100.0)
        p_fast = raster_cuda.raster_fast_pooled_plain(rec_f, box_f, s, s, 100.0)
        torch.cuda.synchronize()
        fast_err = float((k_fast - p_fast).abs().max())
        if not fast_err <= FAST_MAX_ERR:
            fail(f"{tag}: fast kernel vs plain fast max |diff| {fast_err}")
        return st["max_abs_err"], fast_err, k_fast, p_exact, rec_f, box_f

    # ---------------------------------------------------------------- 3
    _, _, planes8 = hand_planes(8, args.seed)
    fv8 = face_vertices(planes8)
    e_err, f_err, k_fast, p_exact, rec_f, box_f = compare(fv8, samples, 640, "hand B=8")
    fast_raw = raster_cuda.raster_fast_pooled_plain(rec_f, box_f, samples, samples, None)
    exact_pooled = pool_2x2(torch.clamp(p_exact, max=100.0))
    fst = contracts.fast_stats(k_fast, exact_pooled, fast_raw, p_exact)
    if not contracts.fast_ok(fst):
        fail(f"fast kernel vs plain exact: {fst}")
    log(f"[3] hand B=8: exact |diff| max {e_err:.3g}, fast |diff| max {f_err:.3g}, "
        f"fast vs exact {json.dumps(fst)}")
    for name, faces, size in adversarial_cases():
        s = samples if size == 640 else torch.arange(size, dtype=torch.float32, device=dev)
        e_err, f_err, *_ = compare(torch.as_tensor(faces, device=dev), s, size, name)
        log(f"    {name}: exact max {e_err:.3g}, fast max {f_err:.3g}")

    # ---------------------------------------------------------------- 4
    params = load_params_npz(PARAMS)
    estimator = PoseEstimator(params, num_stacks=1, denoise=True, precision="highest",
                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    poses = sample_poses(gen, MAIN_BATCH)
    torch.cuda.synchronize()
    raster_cuda.reset_launch_counts()
    errors = {}
    crops = {}
    for mode, exact in (("fast", False), ("exact", True)):
        synt = synthesize(model, torch.Generator(device=dev).manual_seed(args.seed + 2),
                          poses, add_noise=True, exact=exact)
        joints = estimator.predict(synt.dms * 100.0)
        gt = synt.xyz.cpu().numpy()
        if not (joints.shape == gt.shape == (MAIN_BATCH, 41, 3)):
            fail(f"{mode}: joints shape {joints.shape}")
        errors[mode] = float(np.linalg.norm(joints - gt, axis=-1).mean())
        crops[mode] = (synt.dms * 100.0, joints)
    torch.cuda.synchronize()
    launches = dict(raster_cuda.LAUNCHES)
    log(f"[4] B={MAIN_BATCH} mean joint error fast {errors['fast']:.3f} mm, exact "
        f"{errors['exact']:.3f} mm; launches {launches}")
    for mode, err in errors.items():
        if not err < 25.0:
            fail(f"{mode} mean joint error {err} mm >= 25")
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the main path")
    cpu_est = PoseEstimator(params, num_stacks=1, denoise=True, precision="highest",
                            device="cpu")
    dms_fast, joints_fast = crops["fast"]
    cpu_joints = cpu_est.predict(dms_fast.cpu())
    cpu_diff = float(np.abs(cpu_joints - joints_fast).max())
    log(f"    same crops on the CPU: max |diff| {cpu_diff:.3g} mm")
    if not cpu_diff <= 1e-2:
        fail(f"GPU vs CPU serving max |diff| {cpu_diff} mm > 1e-2")

    # ---------------------------------------------------------------- 5
    kernel_rows = []
    for batch in BATCHES:
        tr, rand_f, planes = hand_planes(batch, args.seed + 3)
        fv = face_vertices(planes)
        rec_f, box_f = raster_cuda.prepass_fast(planes=planes)
        rec_e, box_e = raster_cuda.prepass_exact(planes=planes)
        t = {
            "render_fast_ms": time_ms(lambda: render_depth_64(model, tr, rand_f), REPS),
            "render_exact_ms": time_ms(
                lambda: render_depth_64(model, tr, rand_f, exact=True), REPS),
            "raster_fast_pooled_ms": time_ms(lambda: raster_cuda.launch_raster_fast_pooled(
                rec_f, box_f, samples, samples, 100.0), REPS),
            "raster_exact_ms": time_ms(lambda: raster_cuda.launch_raster_exact(
                rec_e, box_e, samples, samples, 640), REPS),
            "plain_fast_ms": time_ms(lambda: raster_cuda.raster_fast_pooled_plain(
                rec_f, box_f, samples, samples, 100.0), REPS, warmup=1),
            "plain_exact_ms": time_ms(
                lambda: rasterize_depth(fv, samples, samples), REPS, warmup=1),
            "prepass_fast_ms": time_ms(
                lambda: raster_cuda.prepass_fast(planes=planes), REPS),
            "prepass_exact_ms": time_ms(
                lambda: raster_cuda.prepass_exact(planes=planes), REPS),
        }
        if batch == MAIN_BATCH:
            dms_mm = dms_fast
            t["predict_ms"] = time_ms(lambda: estimator.predict(dms_mm), REPS)
        # bounds: the inputs the function needs read once, the canvas written
        # once; operations = face-sample tests of a binned render x ops per
        # test. The fast box is part of fast-mode coverage; the exact box is
        # only a skip, so exact counts the needed record fields alone.
        n = samples.numel()
        num_faces = rec_e.shape[1]
        fast_bytes = 4 * (rec_f.numel() + box_f.numel() + 2 * n + batch * (n // 2) ** 2)
        exact_bytes = 4 * (batch * num_faces * EXACT_FIELDS_NEEDED + 2 * n + batch * n * n)
        fast_tests = face_sample_tests(box_f, samples, samples)
        exact_tests = face_sample_tests(box_e, samples, samples)
        t["raster_fast_pooled_bound"] = bound(fast_bytes, fast_tests * FAST_OPS_PER_TEST)
        t["raster_exact_bound"] = bound(exact_bytes, exact_tests * EXACT_OPS_PER_TEST)
        t["fast_tests"], t["exact_tests"] = fast_tests, exact_tests
        log(f"[5] B={batch} " + json.dumps(t))
        if batch != MAIN_BATCH:
            continue
        # the kernels at the main path's batch, held to the same limits as
        # in phase 3
        exact_err, fast_err, *_ = compare(fv, samples, 640, f"main batch B={batch}")
        log(f"    B={batch}: exact |diff| max {exact_err:.3g}, fast |diff| max {fast_err:.3g}")
        for name, err, plain_key, src in (
            ("raster_fast_pooled", fast_err, "plain_fast_ms", 633),
            ("raster_exact", exact_err, "plain_exact_ms", 756),
        ):
            b_ms, b_by = t[f"{name}_bound"]
            kernel_rows.append({
                "name": name, "route": "cuda", "source": "spherehand_torch/csrc/raster.cu",
                "replaces": f"spherehand_tpu/render/raster_pallas.py:{src}",
                "launches": launches[name], "max_abs_err": err, "ms": t[f"{name}_ms"],
                "plain_ms": t[plain_key], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
            })

    # ---------------------------------------------------------------- 6
    size = 64
    real = render_multiview_batch(model, torch.Generator(device=dev).manual_seed(args.seed + 4),
                                  EngineConfig().real_batch)
    num_views = real.dms.shape[1]
    projected = apply_rigid(mutual_transforms(real.poses, real.inv_poses), real.keypoints[:, :, None])
    sph_centers = projected.reshape(-1, model.kp_radius.shape[0], 3).contiguous()
    sph_target = real.dms.reshape(-1, size, size).contiguous()
    sph_radii = model.kp_radius.contiguous()
    adv = [torch.as_tensor(a, device=dev) for a in sphere_adversarial_case(views=num_views)]
    sphere_stats = {}
    for tag, (c, t, r) in (("hands N=%d" % sph_centers.shape[0], (sph_centers, sph_target, sph_radii)),
                           ("adversarial", adv)):
        st = contracts.sphere_kernel_stats(c, t, r, size, num_views,
                                           torch.Generator(device=dev).manual_seed(args.seed + 5))
        ties = contracts.sphere_tie_violations(st) if tag == "adversarial" else 0
        st.pop("kernel")
        log(f"[6] sphere kernels, {tag}: {json.dumps(st)}; tie violations {ties}")
        if not contracts.sphere_ok(st) or ties:
            fail(f"sphere kernels vs plain versions ({tag}): {st}, tie violations {ties}")
        sphere_stats[tag] = st
    main_sphere = sphere_stats["hands N=%d" % sph_centers.shape[0]]

    # ---------------------------------------------------------------- 7
    cfg = EngineConfig()
    fns = build_steps(cfg, hand=model)
    state = train_state_from_params(fns.init_state, params)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 6)
    before = [p.detach().clone() for p in state.network.parameters()]
    torch.cuda.synchronize()
    raster_cuda.reset_launch_counts()
    sphere_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    train_real = render_multiview_batch(model, gen, cfg.real_batch)
    real_batch = RealBatch(*train_real[:4])
    train_metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = fns.synt_step(state, cfg.lr, fns.draw(gen, real=False))
        train_metrics.append(("synt", m))
    for is_mv in (True, True, False):
        state, m, _ = fns.combined_step(state, cfg.lr, fns.draw(gen), real_batch, is_mv)
        train_metrics.append((f"combined is_mv={is_mv}", m))
    eval_metrics, denoised = fns.eval_step(state, fns.draw(gen, synt=False), real_batch)
    train_metrics.append(("eval", eval_metrics))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {**raster_cuda.LAUNCHES, **sphere_cuda.LAUNCHES}
    for name, m in train_metrics:
        vals = {k: float(v) for k, v in m.items()}
        log(f"[7] {name}: {json.dumps(vals)}")
        if not all(np.isfinite(v) for v in vals.values()):
            fail(f"{name}: a metric is not finite: {vals}")
    moved = sum(not torch.equal(a, b) for a, b in zip(before, state.network.parameters()))
    log(f"    {train_s:.2f} s; parameters moved {moved}/{len(before)}; launches {train_launches}")
    if moved != len(before) or tuple(denoised.shape) != (cfg.real_batch, 41, 3):
        fail(f"training moved {moved}/{len(before)} parameters, eval shape {tuple(denoised.shape)}")
    for name, n in train_launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the training path")

    # ---------------------------------------------------------------- 8
    with np.load(GRAD_PARITY) as gold:
        gp_dms, gp_poses, gp_inv = (np.asarray(gold[k], np.float32)
                                    for k in ("real_dms", "real_poses", "real_inv_poses"))
    small = EngineConfig(synt_batch=8, real_batch=gp_dms.shape[0])
    side_fns = {"gpu": build_steps(small, hand=model),
                "cpu": build_steps(small, hand=load_hand_model(device="cpu"))}
    draws = side_fns["cpu"].draw(torch.Generator().manual_seed(args.seed + 7))
    # one synthetic batch, rendered on the card, handed to both sides
    gpu_draws = draws.to(dev)
    synt = synthesize_from_draws(model, gpu_draws.poses, gpu_draws.synthesis)
    sides = {}
    for side, sdev in (("gpu", dev), ("cpu", torch.device("cpu"))):
        sfns = side_fns[side]
        sstate = train_state_from_params(sfns.init_state, params)
        sbatch = RealBatch(*(torch.as_tensor(a, device=sdev) for a in
                             (gp_dms, np.zeros(gp_dms.shape[:2] + (36, 3), np.float32),
                              gp_poses, gp_inv)))
        with float32_precision("highest"):
            _, terms, grads = sfns.combined_grads(
                sstate, draws.to(sdev), sbatch, True,
                synt=type(synt)(*(x.to(sdev) for x in synt)))
        sides[side] = ({k: float(v) for k, v in terms.items()},
                       {k: float(g.norm()) for k, g in grads.items()})
    term_rel = max(abs(sides["gpu"][0][k] - v) / max(abs(v), 1e-12)
                   for k, v in sides["cpu"][0].items() if v != 0.0)
    gnorm_rel = max(abs(sides["gpu"][1][k] - v) / max(v, 1e-30)
                    for k, v in sides["cpu"][1].items())
    log(f"[8] combined_grads GPU vs CPU (8 + {gp_dms.shape[0]}x{gp_dms.shape[1]}, TF32 off): "
        f"terms max rel {term_rel:.3g}, gradient norms max rel {gnorm_rel:.3g}; "
        f"GPU terms {json.dumps(sides['gpu'][0])}")
    if not (term_rel <= GPU_CPU_TERM_REL and gnorm_rel <= GPU_CPU_GNORM_REL):
        fail(f"GPU vs CPU combined_grads: terms {term_rel}, gradient norms {gnorm_rel}")

    # ---------------------------------------------------------------- 9
    args_k = (sph_centers, sph_target, sph_radii, size, num_views)
    fwd = sphere_cuda.launch_fused(*args_k, residuals=True)
    g_depth, g_dist = torch.ones_like(fwd[0]), torch.ones_like(fwd[1])
    bwd_args = (sph_centers, sph_target, num_views, g_depth, g_dist, *fwd[2:])
    sph = {
        "sphere_fused_fwd_ms": time_ms(lambda: sphere_cuda.launch_fused(*args_k, residuals=True), REPS),
        "sphere_fused_primal_ms": time_ms(
            lambda: sphere_cuda.launch_fused(*args_k, residuals=False), REPS),
        "sphere_fused_bwd_ms": time_ms(lambda: sphere_cuda.launch_fused_bwd(*bwd_args), REPS),
        "plain_fwd_ms": time_ms(lambda: sphere_cuda.fused_fwd_plain(*args_k), REPS, warmup=1),
        "plain_primal_ms": time_ms(lambda: sphere_cuda.fused_primal_plain(*args_k), REPS, warmup=1),
        "plain_bwd_ms": time_ms(lambda: sphere_cuda.fused_bwd_plain(*bwd_args), REPS, warmup=1),
        "synt_step_ms": time_ms(
            lambda: fns.synt_step(state, cfg.lr, fns.draw(gen, real=False)), REPS),
        "combined_step_ms": time_ms(
            lambda: fns.combined_step(state, cfg.lr, fns.draw(gen), real_batch, True), REPS),
        "eval_step_ms": time_ms(
            lambda: fns.eval_step(state, fns.draw(gen, synt=False), real_batch), REPS),
    }
    n_img, num_j = sph_centers.shape[:2]
    pixels = size * size
    plane_bytes = 4 * n_img * pixels
    in_bytes = 4 * (sph_centers.numel() + sph_radii.numel() + sph_target.numel())
    sph["sphere_fused_fwd_bound"] = bound(in_bytes + 6 * plane_bytes,
                                          n_img * pixels * num_j * SPHERE_FWD_OPS)
    sph["sphere_fused_primal_bound"] = bound(in_bytes + 2 * plane_bytes,
                                             n_img * pixels * num_j * SPHERE_PRIMAL_OPS)
    sph["sphere_fused_bwd_bound"] = bound(
        4 * (sph_centers.numel() + sph_target.numel()) + 6 * plane_bytes + 4 * sph_centers.numel(),
        n_img * pixels * SPHERE_BWD_OPS_PIXEL + n_img * num_j * SPHERE_BWD_OPS_SPHERE)
    log(f"[9] N={n_img} J={num_j} S={size}; steps at {cfg.synt_batch} + {cfg.real_batch}x"
        f"{num_views}: " + json.dumps(sph))
    for name, src, err_key, plain_key in (
        ("sphere_fused_primal", 227, "primal_max_abs_err", "plain_primal_ms"),
        ("sphere_fused_fwd", 253, "fields_max_abs_err", "plain_fwd_ms"),
        ("sphere_fused_bwd", 308, "bwd_max_abs_err", "plain_bwd_ms"),
    ):
        b_ms, b_by = sph[f"{name}_bound"]
        kernel_rows.append({
            "name": name, "route": "cuda", "source": "spherehand_torch/csrc/sphere.cu",
            "replaces": f"spherehand_tpu/render/sphere_pallas.py:{src}",
            "launches": train_launches[name], "max_abs_err": main_sphere[err_key],
            "ms": sph[f"{name}_ms"], "plain_ms": sph[plain_key], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
        })

    print(json.dumps({"kernels": kernel_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
