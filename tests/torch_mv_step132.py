"""Write ``tests/goldens/torch_mv_step132.npz``: the inputs of the mutual
projection loss at step 132 of ``test_torch_trajectory.py``'s 600-step case,
where the port's teacher-forced update first departs from JAX's.

Both engines run that case's loop (600 train hands, ``mv_iters`` 150) up to
step 132 only; the state is JAX's before step 132 (weights, Adam moments,
count) and the inputs are that step's (the batch, JAX's draws, ``is_mv``).
On that state each package's ``combined_term_diag`` runs once (JAX jitted,
JAX op by op, the port), and a spy on each package's
``multitask.mutual_projection_loss`` records what the term was given.

The file holds (arrays float32 unless said):

- ``joints_jax`` / ``joints_jax_eager`` / ``joints_port`` /
  ``joints_port_einsum`` (2, 3, 41, 3): the joints that JAX's network gives,
  jitted and op by op, and those the port's network gives on JAX's weights;
- ``poses``, ``inv_poses`` (2, 3, 4, 4), ``real_dms`` (2, 3, 64, 64),
  ``radii`` (41,), ``weights`` (2,; NaN where the step gave none), ``is_mv``
  (bool);
- ``mv_value_*`` and ``mv_grad_*`` (2, 3, 41, 3): the mv term (its loss
  weight included) and its gradient with respect to the joints, for
  ``jax`` (jitted JAX on JAX's joints), ``jax_eager`` (op-by-op JAX on
  op-by-op JAX's joints), ``port`` (the port on its own joints) and
  ``port_einsum`` (the same with the view transforms as einsums, the
  rounding the port had before it took XLA's order on the CPU);
- ``diag_*``: each package's term diag of the mv term and of the total, as
  (value, grad_norm, cos_total, total_grad_norm); ``diag_jax_on_port_joints``
  the control, JAX's with the mv term's joints moved to the port network's
  values (``xyz + stop_gradient(joints_port - xyz)``, the gradient still
  through JAX's network);
- ``update_distances``: from the same state, |u_port - u_jax| / |u_jax| of
  the two packages' updates (the trajectory test's teacher-forced
  distance), then the port's update against JAX's step on the port's
  joints, and JAX's step on the port's joints against JAX's own.

Run from the repository root (about 20 minutes, most of it writing 600
hands; one torch thread)::

    JAX_PLATFORMS=cpu python tests/torch_mv_step132.py \\
        --out tests/goldens/torch_mv_step132.npz --work /tmp/step132

and ``--report tests/goldens/torch_mv_step132.npz`` prints what the file
shows below the term (seconds): the joints' gaps, both packages' mv
gradients on the same joints and on their own, the joint and the pixel
that carry the gap, and the pixels whose silhouette differs.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:  # as tests/conftest.py
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import spherehand_torch.losses.multitask as port_multitask  # noqa: E402
import spherehand_torch.train.steps as port_steps  # noqa: E402
import spherehand_tpu.losses.multitask as jax_multitask  # noqa: E402
import test_torch_trajectory as traj  # noqa: E402
from spherehand_torch.data import pseudo_real  # noqa: E402
from spherehand_torch.losses import multiview  # noqa: E402
from spherehand_torch.losses.multitask import LOSS_WEIGHTS  # noqa: E402
from spherehand_torch.losses.multiview import mutual_projection_loss  # noqa: E402
from spherehand_torch.tools.selfsup_demo import TEST_SEED_OFFSET  # noqa: E402
from spherehand_tpu.hand.assets import load_hand_model as jload_hand_model  # noqa: E402
from spherehand_tpu.losses.multiview import (  # noqa: E402
    mutual_projection_loss as jmutual_projection_loss)
from spherehand_tpu.train.config import EngineConfig as JEngineConfig  # noqa: E402
from spherehand_tpu.train.steps import RealBatch as JRealBatch  # noqa: E402
from spherehand_tpu.train.steps import TrainState as JTrainState  # noqa: E402

STEP, TRAIN_N, MV_ITERS = 132, 600, 150
W_MV = LOSS_WEIGHTS["mv_projection"]


class _Stop(Exception):
    pass


def _weights(weights):
    """None where the step gave no row weights (recorded as NaN)."""
    return None if np.isnan(np.asarray(weights)).any() else weights


def jax_mv_term(joints, poses, inv_poses, real_dms, radii, is_mv, weights):
    """JAX's mv term (loss weight included), a function of the joints;
    ``weights`` None or the row weights."""
    return W_MV * jmutual_projection_loss(poses, inv_poses, joints, real_dms, radii,
                                          is_mv=is_mv, weights=weights)[0]


def port_mv_term(joints, poses, inv_poses, real_dms, radii, is_mv, weights):
    """The port's mv term on the CPU and its gradient to the joints."""
    leaf = torch.as_tensor(joints).clone().requires_grad_(True)
    t = torch.as_tensor
    weights = _weights(weights)
    value = W_MV * mutual_projection_loss(t(poses), t(inv_poses), leaf, t(real_dms), t(radii),
                                          is_mv=bool(is_mv),
                                          weights=None if weights is None else t(weights))[0]
    value.backward()
    return float(value.detach()), leaf.grad.numpy()


def _spy(module, name, record, jax_side):
    real = getattr(module, name)

    def spy(poses, inv_poses, xyz, real_dms, radii, is_mv=True, weights=None, **kwargs):
        if jax_side:
            jax.debug.callback(lambda *a: record.append([np.array(x) for x in a]),
                               xyz, poses, inv_poses, real_dms, radii, is_mv,
                               jnp.full(xyz.shape[0], np.nan) if weights is None else weights)
        else:
            record.append([np.array(x.detach()) if torch.is_tensor(x) else np.array(x)
                           for x in (xyz, poses, inv_poses, real_dms, radii, is_mv,
                                     torch.full((xyz.shape[0],), float("nan"))
                                     if weights is None else weights)])
        return real(poses, inv_poses, xyz, real_dms, radii, is_mv=is_mv, weights=weights, **kwargs)
    return spy


def _diag_row(diag) -> np.ndarray:
    return np.array([float(diag[f"mv_projection/{k}"]) for k in ("value", "grad_norm",
                                                                  "cos_total")]
                    + [float(diag["total_grad_norm"])], np.float64)


def capture(work: str) -> dict:
    torch.set_num_threads(1)
    hand_model = jload_hand_model()
    data = os.path.join(work, "data")
    t0 = time.time()
    for split, n, seed in (("train", TRAIN_N, 0), ("test", 4, TEST_SEED_OFFSET)):
        if not os.path.exists(os.path.join(data, split, "mv_data_0_shape.pkl")):
            pseudo_real.generate_pseudo_nyu(os.path.join(data, split), n, seed, "cpu")
    print(f"data {time.time() - t0:.1f} s", flush=True)
    cache = os.path.join(work, f"state{STEP}.pkl")
    with pytest.MonkeyPatch.context() as mp:
        jeng = traj._jax_engine(traj._config(JEngineConfig, data, os.path.join(work, "jax"),
                                             MV_ITERS, data_parallel=False), mp)
        port = traj._port_engine(traj._config(traj.EngineConfig, data,
                                              os.path.join(work, "port"), MV_ITERS))
        to_port = traj._jax_step_draws(hand_model, traj.SYNT, traj.REAL * 3)
        draws_of = lambda e, i: to_port(jeng._step_key(e, i))  # noqa: E731
        mp.setattr(port_steps, "synthesize_from_draws", lambda hand, synt, *_a, **_k: synt)
        steps, jax_fns = port.steps, jeng.steps
        real_step, seen = port.steps.combined_step, {}

        def stop_after(state, lr, draws, batch, is_mv):
            seen["n"] = seen.get("n", 0) + 1
            if seen["n"] > STEP:
                raise _Stop
            if seen["n"] == STEP:
                seen.update(lr=lr, draws=draws, batch=batch, is_mv=bool(is_mv))
            out = real_step(state, lr, draws, batch, is_mv)
            seen.setdefault("metric_keys", list(out[1]))
            return out

        if os.path.exists(cache):
            with open(cache, "rb") as f:
                seen = pickle.load(f)
        else:
            port.steps = port.steps._replace(combined_step=stop_after)
            try:
                traj._run_port(port, 1, draws_of, lambda n: False, mp)
            except _Stop:
                pass
            print(f"port loop to step {STEP}: {time.time() - t0:.1f} s", flush=True)

            def on_step(n, before, _after, _metrics):
                if n == STEP:
                    seen["before"] = before
                    raise _Stop

            try:
                traj._run_jax(jeng, 1, seen["metric_keys"], on_step, mp)
            except _Stop:
                pass
            print(f"JAX loop to step {STEP}: {time.time() - t0:.1f} s", flush=True)
            with open(cache, "wb") as f:
                pickle.dump({k: seen[k] for k in ("before", "batch", "draws", "is_mv", "lr")},
                            f)
    before, batch, draws = seen["before"], seen["batch"], seen["draws"]
    key = jeng._step_key(0, STEP - 1)
    t = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    jbatch = JRealBatch(t(batch.dms), t(batch.gt_joints), t(batch.poses), t(batch.inv_poses))
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=traj._nest(before["params"]),
                         opt_state=before["opt_state"], prev_skel=jnp.zeros((3, 41, 3)),
                         has_prev=jnp.zeros((), bool))
    out = {}
    for tag, jit in (("jax", True), ("jax_eager", False)):
        record = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_multitask, "mutual_projection_loss",
                       _spy(jax_multitask, "mutual_projection_loss", record, True))
            if jit:
                diag = jax.jit(jax_fns.combined_term_diag)(jstate, key, jbatch,
                                                           jnp.asarray(seen["is_mv"]))
            else:
                with jax.disable_jit():
                    diag = jax_fns.combined_term_diag(jstate, key, jbatch,
                                                      jnp.asarray(seen["is_mv"]))
            jax.effects_barrier()
        out[f"diag_{tag}"] = _diag_row(diag)
        joints, *inputs = record[0]
        out[f"joints_{tag}"] = joints
        w = _weights(inputs[-1])
        term = jax.value_and_grad(lambda j: jax_mv_term(j, *inputs[:-1], w))
        if jit:
            value, grad = jax.jit(term)(joints)
        else:
            with jax.disable_jit():
                value, grad = term(joints)
        out[f"mv_value_{tag}"], out[f"mv_grad_{tag}"] = np.float64(value), np.array(grad)
        print(f"{tag}: diag {out[f'diag_{tag}']}, term {float(value)}, "
              f"{time.time() - t0:.1f} s", flush=True)
    for k, v in zip(("poses", "inv_poses", "real_dms", "radii", "is_mv", "weights"), inputs):
        out[k] = np.array(v)

    probe = steps.init_state(torch.Generator().manual_seed(0))
    traj.convert.load_hourglass(probe.network, traj._nest(before["params"]))
    mu, nu = (traj.convert.hourglass_state_dict(traj._nest(before[k])) for k in ("mu", "nu"))
    probe.optimizer.state.clear()
    for name, p in probe.network.named_parameters():
        probe.optimizer.state[p] = {"step": torch.tensor(float(before["count"])),
                                    "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    for tag, order in (("port", multiview._exact_order), ("port_einsum", lambda *_t: False)):
        record = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_multitask, "mutual_projection_loss",
                       _spy(port_multitask, "mutual_projection_loss", record, False))
            mp.setattr(multiview, "_exact_order", order)
            diag = steps.combined_term_diag(probe, draws, batch, seen["is_mv"],
                                            synt=draws.poses)
            out[f"diag_{tag}"] = _diag_row(diag)
            out[f"joints_{tag}"] = record[0][0]
            out[f"mv_value_{tag}"], out[f"mv_grad_{tag}"] = port_mv_term(
                out[f"joints_{tag}"], *(out[k] for k in ("poses", "inv_poses", "real_dms",
                                                          "radii", "is_mv", "weights")))
        print(f"{tag}: diag {out[f'diag_{tag}']}, term {out[f'mv_value_{tag}']}, "
              f"{time.time() - t0:.1f} s", flush=True)

    # The control: JAX's term diag and step with the mv term's joints moved
    # to the port network's values (the gradient still through JAX's network).
    shift = jnp.asarray(out["joints_port"])
    real_mv = jax_multitask.mutual_projection_loss

    def on_port_joints(poses, inv_poses, xyz, *args, **kwargs):
        return real_mv(poses, inv_poses, xyz + jax.lax.stop_gradient(shift - xyz), *args,
                       **kwargs)

    def jax_update(shifted: bool) -> np.ndarray:
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=traj._nest(before["params"]),
                            opt_state=before["opt_state"], prev_skel=jnp.zeros((3, 41, 3)),
                            has_prev=jnp.zeros((), bool))
        with pytest.MonkeyPatch.context() as mp:
            if shifted:
                mp.setattr(jax_multitask, "mutual_projection_loss", on_port_joints)
            # a fresh function, so that jit traces it with the patch in place
            new, _, _ = jax.jit(lambda *a: jax_fns.combined_step(*a))(
                state, key, jnp.float32(seen["lr"]), jbatch, jnp.asarray(seen["is_mv"]))
        return traj._flat(traj.convert.flatten_params(jax.device_get(new.params)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_multitask, "mutual_projection_loss", on_port_joints)
        diag = jax.jit(lambda *a: jax_fns.combined_term_diag(*a))(jstate, key, jbatch,
                                                                 jnp.asarray(seen["is_mv"]))
    out["diag_jax_on_port_joints"] = _diag_row(diag)
    start = traj._flat(before["params"])
    u_jax, u_shift = jax_update(False) - start, jax_update(True) - start
    rec = {"lr_given": seen["lr"], "batch": batch, "is_mv": seen["is_mv"]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_steps, "synthesize_from_draws", lambda hand, synt, *_a, **_k: synt)
        _, moved, _ = traj._forced_step(steps, probe, before, rec, draws.poses, draws)
    u_port = traj._flat(moved) - start
    # |u_port - u_jax| / |u_jax| (the test's teacher-forced distance), the
    # port against JAX on the port's joints, and JAX on the port's joints
    # against JAX
    out["update_distances"] = np.array([traj._rel(u_port, u_jax), traj._rel(u_port, u_shift),
                                        traj._rel(u_shift, u_jax)])
    print(f"JAX on the port's joints: diag {out['diag_jax_on_port_joints']}; update distances "
          f"{out['update_distances']}, {time.time() - t0:.1f} s", flush=True)
    return out


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b))


def report(path: str) -> dict:
    """What the file shows, below the term: the joints' gaps, the mv
    gradient to the joints of both packages on the same joints and on each
    one's own, where the gap sits (joint, then pixel: forward-mode
    derivatives of the per-pixel loss maps to that joint), and the pixels
    whose silhouette differs between the two joint sets."""
    from torch.func import jvp

    from spherehand_torch.render.sphere import _mm_grid, ieee_sqrt, render_spheres

    g = dict(np.load(path))
    inputs = [g[k] for k in ("poses", "inv_poses", "real_dms", "radii", "is_mv")]
    w = _weights(g["weights"])

    def jax_grad(joints):
        term = jax.value_and_grad(lambda j: jax_mv_term(j, *inputs, w))
        return np.asarray(jax.jit(term)(joints)[1])

    out = {"joints_port_vs_jax_mm": float(np.abs(g["joints_port"] - g["joints_jax"]).max()),
           "joints_jax_eager_vs_jit_mm": float(np.abs(g["joints_jax_eager"]
                                                      - g["joints_jax"]).max())}
    for joints in ("joints_jax", "joints_port"):
        want = jax_grad(g[joints])
        got = port_mv_term(g[joints], *inputs, g["weights"])[1]
        out[f"port_vs_jax_on_{joints}"] = _rel(got, want)
    with jax.disable_jit():
        eager = np.asarray(jax.value_and_grad(
            lambda j: jax_mv_term(j, *inputs, w))(g["joints_jax"])[1])
    out["jax_eager_vs_jit_on_joints_jax"] = _rel(eager, jax_grad(g["joints_jax"]))
    gap = g["mv_grad_port"] - g["mv_grad_jax"]
    out["own_joints_gap"] = _rel(g["mv_grad_port"], g["mv_grad_jax"])
    per_joint = np.linalg.norm(gap, axis=-1)
    top = np.unravel_index(per_joint.argmax(), per_joint.shape)
    out["top_joint"] = [int(i) for i in top]
    out["top_joint_share_of_gap"] = float(per_joint[top] / np.linalg.norm(gap))

    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    poses, inv, real, radii = t(g["poses"]), t(g["inv_poses"]), t(g["real_dms"]), t(g["radii"])
    mats = multiview.mutual_transforms(poses, inv)

    def pixel_maps(joints):
        """The mv branch's per-pixel terms, m2d and 500 d2m (is_mv on)."""
        proj = multiview.apply_rigid(mats, joints[:, :, None])
        dms = render_spheres(proj, radii, 64).amin(dim=-3)
        target = real[:, None].expand_as(dms)
        xg, yg = _mm_grid(64, 64)
        p_sq = xg * xg + yg * yg + target * target
        cx, cy, cz = (proj[..., k, None, None] for k in range(3))
        sq = torch.clamp(p_sq[..., None, :, :] - 2.0 * (xg * cx + yg * cy + target[..., None, :, :]
                                                       * cz) + (cx * cx + cy * cy + cz * cz),
                         min=1e-6)
        dist = torch.abs(ieee_sqrt(sq) - radii[..., None, None])
        dist = torch.where((target > 99.0)[..., None, :, :], torch.zeros_like(dist), dist)
        return torch.stack([(dms - target) ** 2,
                            500.0 * torch.clamp(dist.amin(dim=-3), 0.0, 50.0)])

    derivs = []
    for joints in ("joints_jax", "joints_port"):
        cols = []
        for k in range(3):
            tangent = torch.zeros(g[joints].shape)
            tangent[top + (k,)] = 1.0
            cols.append(jvp(pixel_maps, (t(g[joints]),), (tangent,))[1])
        derivs.append(torch.stack(cols, -1))  # (field, B, V, V, S, S, 3)
    pixel_gap = (derivs[1] - derivs[0]).norm(dim=-1)
    at = np.unravel_index(int(pixel_gap.argmax()), pixel_gap.shape)
    out["top_pixel"] = {"field": ["m2d", "d2m"][at[0]], "b_i_j_v_u": [int(i) for i in at[1:]],
                        "share_of_joint_gap": float(pixel_gap.max() / (derivs[1] - derivs[0])
                                                    .sum(dim=tuple(range(6))).norm())}
    inside = [render_spheres(multiview.apply_rigid(mats, t(g[j])[:, :, None]), radii, 64) != 100.0
              for j in ("joints_jax", "joints_port")]
    out["silhouette_flips_b_i_j_sphere_v_u"] = (inside[0] != inside[1]).nonzero().tolist()
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the file here")
    parser.add_argument("--work", help="directory for the shards and runs")
    parser.add_argument("--report", help="print what a written file shows (seconds)")
    args = parser.parse_args(argv)
    if args.report:
        torch.set_num_threads(4)
        print(json.dumps(report(args.report)), flush=True)
        return
    out = capture(args.work)
    np.savez_compressed(args.out, **{k: np.asarray(v) for k, v in out.items()})
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes", flush=True)


if __name__ == "__main__":
    main()
