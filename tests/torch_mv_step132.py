"""Write ``tests/goldens/torch_mv_step132.npz`` (``--step 132``, the
default) or ``torch_mv_step507.npz`` (``--step 507 --every_term``): the
inputs of the loss at a step of ``test_torch_trajectory.py``'s 600-step
case where the port's teacher-forced update departs from JAX's (132 and
507, counted from 1; 300 steps an epoch, ``is_mv`` for the first 150).

Both engines run that case's loop (600 train hands, ``mv_iters`` 150) up to
that step only; the state is JAX's before the step (weights, Adam moments,
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

With ``--every_term`` it also holds, for every term ``T`` of the objective
(sorted in ``term_names``):

- ``real_joints_*`` (2, 3, 41, 3) and ``synt_joints_*`` (1, 41, 3): the
  joints that reach the loss, for ``jax``, ``jax_eager`` and ``port``;
- ``term_T_E_on_A`` (its value), ``term_grad_real_T_E_on_A`` and
  ``term_grad_synt_T_E_on_A`` (its gradient to the real and synthetic
  joints), for the evaluator ``E`` (``jax`` jitted, ``jax_eager`` op by op,
  ``port``) on the joints ``A`` (``own``, ``jax``'s, ``port``'s), the other
  inputs each package's own; a term of the heatmaps has zero gradients;
- ``diag_terms_*`` (terms, 3): each package's term diag, value, gradient
  norm and cosine with the total;
- ``synt_target_xyz`` (the port's) and ``synt_target_xyz_jax``, ``vae_noise``
  (the port's prior noise) and ``prior_key_data`` (JAX's prior key): the
  other inputs of the terms of the joints;
- ``moved_names`` and ``moved_distances`` (n, 2): JAX's jitted step with
  one term's joints moved to the port network's values (each term of the
  joints, then ``all``): |u_port - u| / |u| and |u - u_jax| / |u_jax| of
  its update u;
- ``control_distance``: JAX's step op by op against jitted,
  |u_eager - u_jax| / |u_jax|, the slow case's control; and ``step``.

Run from the repository root (about 20 minutes for step 132, most of it
writing 600 hands; the hands are kept in ``--work`` for another step; one
torch thread)::

    JAX_PLATFORMS=cpu python tests/torch_mv_step132.py \\
        --out tests/goldens/torch_mv_step132.npz --work /tmp/step132
    JAX_PLATFORMS=cpu python tests/torch_mv_step132.py --step 507 --every_term \\
        --out tests/goldens/torch_mv_step507.npz --work /tmp/step132

and ``--report tests/goldens/torch_mv_step132.npz`` prints what the file
shows below the term (seconds): the joints' gaps, both packages' mv
gradients on the same joints and on their own, the joint and the pixel
that carry the gap, and the pixels whose silhouette differs.
"""
from __future__ import annotations

import argparse
import contextlib
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
import spherehand_tpu.train.steps as jax_steps  # noqa: E402
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

TRAIN_N, MV_ITERS = 600, 150
ITERS = TRAIN_N // traj.REAL  # combined steps an epoch
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


def _spy_terms(module, record: list, jax_side: bool):
    """A spy on a steps module's ``multitask_loss`` that records what it is
    given (numpy on the JAX side, through a debug callback; the port's
    tensors detached) before calling it."""
    real = module.multitask_loss

    def spy(cfg, output, *args, **kwargs):
        if jax_side:
            kw = dict(kwargs)
            typed = kw.get("rng") is not None and jax.dtypes.issubdtype(
                kw["rng"].dtype, jax.dtypes.prng_key)
            if typed:
                kw["rng"] = jax.random.key_data(kw["rng"])
            jax.debug.callback(lambda o, a, k: record.append(
                (cfg, *jax.tree.map(np.array, (o, a, k)), typed)), output, args, kw)
        else:
            record.append((cfg, torch.utils._pytree.tree_map(
                lambda x: x.detach() if torch.is_tensor(x) else x, output), args, kwargs))
        return real(cfg, output, *args, **kwargs)
    return spy


def _joints_of(inputs) -> tuple[np.ndarray, np.ndarray]:
    """The real (B, V, 41, 3) and synthetic (Bs, 41, 3) joints of a recorded
    ``multitask_loss`` call (one stack)."""
    output = inputs[1]
    assert len(output.real_xyz) == len(output.synt_xyz) == 1
    return tuple(np.array(x[0], np.float32) for x in (output.real_xyz, output.synt_xyz))


def jax_term_fns(inputs, jit: bool) -> dict:
    """Each term of JAX's objective on a recorded call, as a function of the
    (real, synthetic) joints, everything else held: name -> f(real, synt)
    -> (value, gradient to real, gradient to synt), jitted or op by op."""
    cfg, output, args, kw, typed = inputs
    kw = dict(kw)
    if typed:
        kw["rng"] = jax.random.wrap_key_data(kw["rng"])

    def terms(real, synt):
        moved = output._replace(real_xyz=(real,), synt_xyz=(synt,))
        return jax_multitask.multitask_loss(cfg, moved, *args, **kw)[0]

    def of(name):
        fn = jax.value_and_grad(lambda r, s: terms(r, s)[name], argnums=(0, 1))
        if jit:
            fn = jax.jit(fn)

        def call(real, synt):
            with contextlib.ExitStack() as stack:
                if not jit:
                    stack.enter_context(jax.disable_jit())
                value, (g_real, g_synt) = fn(jnp.asarray(real), jnp.asarray(synt))
            return float(value), np.array(g_real), np.array(g_synt)
        return call

    names = sorted(jax.eval_shape(terms, *_joints_of(inputs)))
    return {name: of(name) for name in names}


def port_terms(inputs, real, synt) -> dict:
    """Each term of the port's objective on a recorded call at the (real,
    synthetic) joints: name -> (value, gradient to real, gradient to synt)."""
    cfg, output, args, kw = inputs
    out = {}
    names = sorted(port_multitask.multitask_loss(cfg, output, *args, **kw)[0])
    for name in names:
        leaves = [torch.as_tensor(np.array(x)).requires_grad_(True) for x in (real, synt)]
        moved = output._replace(real_xyz=(leaves[0],), synt_xyz=(leaves[1],))
        value = port_multitask.multitask_loss(cfg, moved, *args, **kw)[0][name]
        grads = (torch.autograd.grad(value, leaves, allow_unused=True) if value.requires_grad
                 else (None, None))
        out[name] = (float(value.detach()), *(np.zeros(x.shape, np.float32) if g is None
                                             else g.numpy() for g, x in zip(grads, leaves)))
    return out


def _diag_terms(diag) -> np.ndarray:
    """(terms, 3): each term's value, gradient norm and cosine with the
    total, the terms in sorted order."""
    names = sorted(k.split("/")[0] for k in diag if k.endswith("/value"))
    return np.array([[float(diag[f"{n}/{k}"]) for k in ("value", "grad_norm", "cos_total")]
                     for n in names], np.float64)


def _diag_row(diag) -> np.ndarray:
    return np.array([float(diag[f"mv_projection/{k}"]) for k in ("value", "grad_norm",
                                                                  "cos_total")]
                    + [float(diag["total_grad_norm"])], np.float64)


def capture(work: str, step: int = 132, every_term: bool = False) -> dict:
    """The file's arrays for combined step ``step`` (counted from 1); with
    ``every_term`` also those of every term and the moved-joints steps."""
    torch.set_num_threads(1)
    hand_model = jload_hand_model()
    data = os.path.join(work, "data")
    t0 = time.time()
    for split, n, seed in (("train", TRAIN_N, 0), ("test", 4, TEST_SEED_OFFSET)):
        if not os.path.exists(os.path.join(data, split, "mv_data_0_shape.pkl")):
            pseudo_real.generate_pseudo_nyu(os.path.join(data, split), n, seed, "cpu")
    print(f"data {time.time() - t0:.1f} s", flush=True)
    cache = os.path.join(work, f"state{step}.pkl")
    epochs = (step - 1) // ITERS + 1
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
            if seen["n"] > step:
                raise _Stop
            if seen["n"] == step:
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
                traj._run_port(port, epochs, draws_of, lambda n: False, mp)
            except _Stop:
                pass
            print(f"port loop to step {step}: {time.time() - t0:.1f} s", flush=True)

            def on_step(n, before, _after, _metrics):
                if n == step:
                    seen["before"] = before
                    raise _Stop

            try:
                traj._run_jax(jeng, epochs, seen["metric_keys"], on_step, mp)
            except _Stop:
                pass
            print(f"JAX loop to step {step}: {time.time() - t0:.1f} s", flush=True)
            with open(cache, "wb") as f:
                pickle.dump({k: seen[k] for k in ("before", "batch", "draws", "is_mv", "lr")},
                            f)
    before, batch, draws = seen["before"], seen["batch"], seen["draws"]
    key = jeng._step_key(*divmod(step - 1, ITERS))
    t = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    jbatch = JRealBatch(t(batch.dms), t(batch.gt_joints), t(batch.poses), t(batch.inv_poses))
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=traj._nest(before["params"]),
                         opt_state=before["opt_state"], prev_skel=jnp.zeros((3, 41, 3)),
                         has_prev=jnp.zeros((), bool))
    out, term_inputs = {}, {}
    for tag, jit in (("jax", True), ("jax_eager", False)):
        record, term_record = [], []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_multitask, "mutual_projection_loss",
                       _spy(jax_multitask, "mutual_projection_loss", record, True))
            if every_term:
                mp.setattr(jax_steps, "multitask_loss", _spy_terms(jax_steps, term_record, True))
            if jit:
                diag = jax.jit(jax_fns.combined_term_diag)(jstate, key, jbatch,
                                                           jnp.asarray(seen["is_mv"]))
            else:
                with jax.disable_jit():
                    diag = jax_fns.combined_term_diag(jstate, key, jbatch,
                                                      jnp.asarray(seen["is_mv"]))
            jax.effects_barrier()
        out[f"diag_{tag}"] = _diag_row(diag)
        if every_term:
            term_inputs[tag] = term_record[0]
            out[f"diag_terms_{tag}"] = _diag_terms(diag)
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
        record, term_record = [], []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_multitask, "mutual_projection_loss",
                       _spy(port_multitask, "mutual_projection_loss", record, False))
            mp.setattr(multiview, "_exact_order", order)
            if every_term and tag == "port":
                mp.setattr(port_steps, "multitask_loss",
                           _spy_terms(port_steps, term_record, False))
            diag = steps.combined_term_diag(probe, draws, batch, seen["is_mv"],
                                            synt=draws.poses)
            out[f"diag_{tag}"] = _diag_row(diag)
            if every_term and tag == "port":
                term_inputs[tag] = term_record[0]
                out[f"diag_terms_{tag}"] = _diag_terms(diag)
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

    def jax_update(*patches) -> np.ndarray:
        """JAX's jitted step from ``before``, with (module, name, value)
        patches in place: the weights after it."""
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=traj._nest(before["params"]),
                            opt_state=before["opt_state"], prev_skel=jnp.zeros((3, 41, 3)),
                            has_prev=jnp.zeros((), bool))
        with pytest.MonkeyPatch.context() as mp:
            for patch in patches:
                mp.setattr(*patch)
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
    u_jax = jax_update() - start
    u_shift = jax_update((jax_multitask, "mutual_projection_loss", on_port_joints)) - start
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
    if not every_term:
        return out

    # Every term on each package's own joints and on the same joints (JAX's
    # jitted network's, the port network's).
    own = {tag: _joints_of(term_inputs[tag]) for tag in ("jax", "jax_eager", "port")}
    for tag, (real, synt) in own.items():
        out[f"real_joints_{tag}"], out[f"synt_joints_{tag}"] = real, synt
    for tag in ("jax", "jax_eager", "port"):
        fns = None if tag == "port" else jax_term_fns(term_inputs[tag], jit=tag == "jax")
        for at in ("own", "jax", "port"):
            joints = own[tag if at == "own" else at]
            terms = (port_terms(term_inputs[tag], *joints) if fns is None
                     else {name: fn(*joints) for name, fn in fns.items()})
            for name, (value, g_real, g_synt) in terms.items():
                out[f"term_{name}_{tag}_on_{at}"] = np.float64(value)
                out[f"term_grad_real_{name}_{tag}_on_{at}"] = g_real
                out[f"term_grad_synt_{name}_{tag}_on_{at}"] = g_synt
        print(f"{tag}: every term on three joint sets, {time.time() - t0:.1f} s", flush=True)
    names = sorted(terms)
    out["term_names"] = np.array(names)
    # the other inputs of the terms of the joints, for a test to evaluate
    # them again: the synthetic targets, the port's VAE noise, JAX's prior key
    port_kw, jax_kw = term_inputs["port"][3], term_inputs["jax"][3]
    out["synt_target_xyz"] = np.array(port_kw["synt_target"].xyz)
    out["synt_target_xyz_jax"] = np.array(jax_kw["synt_target"].xyz)
    out["vae_noise"] = np.array(port_kw["vae_noise"][0])
    out["prior_key_data"] = np.array(jax_kw["rng"])

    # JAX's step with a term's joints moved to the port network's values
    # (each term of the joints alone, then every term), the gradient still
    # through JAX's network; and JAX's step op by op, the control.
    shift_real, shift_synt = (jnp.asarray(x) for x in own["port"])
    real_loss = jax_steps.multitask_loss

    def moved_loss(moved_names):
        def loss(cfg, output, *args, **kwargs):
            terms, dms, prev = real_loss(cfg, output, *args, **kwargs)
            (r,), (s,) = output.real_xyz, output.synt_xyz
            at_port = output._replace(
                real_xyz=(r + jax.lax.stop_gradient(shift_real - r),),
                synt_xyz=(s + jax.lax.stop_gradient(shift_synt - s),))
            moved = real_loss(cfg, at_port, *args, **kwargs)[0]
            return {k: moved[k] if k in moved_names else v for k, v in terms.items()}, dms, prev
        return loss

    joint_terms = [n for n in names if any(np.abs(out[f"term_grad_{side}_{n}_jax_on_own"]).max()
                                           > 0 for side in ("real", "synt"))]
    rows = []
    for moved_names in [[n] for n in joint_terms] + [names]:
        u = jax_update((jax_steps, "multitask_loss", moved_loss(set(moved_names)))) - start
        rows.append([traj._rel(u_port, u), traj._rel(u, u_jax)])
        print(f"JAX with {moved_names} on the port's joints: {rows[-1]}, "
              f"{time.time() - t0:.1f} s", flush=True)
    out["moved_names"] = np.array(joint_terms + ["all"])
    out["moved_distances"] = np.array(rows)
    eager, _ = traj._jax_eager(jax_fns.combined_step, before,
                               {"batch": batch, "lr": np.float32(seen["lr"]),
                                "is_mv": seen["is_mv"]}, key)
    out["control_distance"] = np.float64(traj._rel(traj._flat(eager) - start, u_jax))
    out["step"] = np.int64(step)
    print(f"control (JAX op by op against jitted): {out['control_distance']}, "
          f"{time.time() - t0:.1f} s", flush=True)
    return out


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b))


def _term_grad(g, name: str, evaluator: str, at: str) -> np.ndarray:
    """A term's gradient to the real and the synthetic joints, flat."""
    return np.concatenate([g[f"term_grad_{side}_{name}_{evaluator}_on_{at}"].ravel()
                           for side in ("real", "synt")])


def report_terms(g: dict) -> dict:
    """What an ``--every_term`` file shows: for each term, the port against
    jitted JAX on the same joints (value relative, gradient over its largest
    entry) beside op-by-op JAX's own gap, and the two packages on their own
    joints; the departure (the update distance over JAX's op-by-op
    control); and which term's moved joints give JAX's step the port's
    update."""
    terms = {}
    for name in g["term_names"]:
        row = {}
        for at in ("jax", "port"):
            want, scale = g[f"term_{name}_jax_on_{at}"], np.abs(_term_grad(g, name, "jax", at))
            for evaluator in ("port", "jax_eager"):
                gap = np.abs(_term_grad(g, name, evaluator, at) - _term_grad(g, name, "jax", at))
                value = g[f"term_{name}_{evaluator}_on_{at}"]
                row[f"{evaluator}_on_{at}"] = [float(abs(value - want) / max(abs(want), 1e-30)),
                                               float(gap.max() / max(scale.max(), 1e-30))]
        own = _term_grad(g, name, "port", "own") - _term_grad(g, name, "jax", "own")
        row["own_joints_gap"] = float(np.linalg.norm(own) / max(
            np.linalg.norm(_term_grad(g, name, "jax", "own")), 1e-30))
        terms[str(name)] = row
    moved = {str(n): [float(x) for x in d] for n, d in zip(g["moved_names"], g["moved_distances"])}
    single = {n: d for n, d in moved.items() if n != "all"}
    return {"step": int(g["step"]), "is_mv": bool(g["is_mv"]), "terms": terms,
            "update_distances": [float(x) for x in g["update_distances"]],
            "control_distance": float(g["control_distance"]),
            "departure_over_control": float(g["update_distances"][0] / g["control_distance"]),
            "moved": moved, "closing_term": min(single, key=lambda n: single[n][0])}


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

    # the pairs of views the term reads: all with is_mv, the own view without
    pairs = torch.ones(3, 3) if bool(g["is_mv"]) else torch.eye(3)

    def pixel_maps(joints):
        """The term's per-pixel parts, m2d and 500 d2m, at the pairs of
        views it reads (zero elsewhere)."""
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
        keep = pairs[None, :, :, None, None]
        return torch.stack([(dms - target) ** 2 * keep,
                            500.0 * torch.clamp(dist.amin(dim=-3), 0.0, 50.0) * keep])

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
    read = pairs.bool()[None, :, :, None, None, None]
    out["silhouette_flips_b_i_j_sphere_v_u"] = ((inside[0] != inside[1]) & read).nonzero().tolist()
    if "term_names" in g:
        out["every_term"] = report_terms(g)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the file here")
    parser.add_argument("--work", help="directory for the shards and runs")
    parser.add_argument("--report", help="print what a written file shows (seconds)")
    parser.add_argument("--step", type=int, default=132,
                        help="the combined step of the 600-step case, counted from 1")
    parser.add_argument("--every_term", action="store_true",
                        help="add every term's values and gradients and the moved-joints steps")
    args = parser.parse_args(argv)
    if args.report:
        torch.set_num_threads(4)
        print(json.dumps(report(args.report)), flush=True)
        return
    out = capture(args.work, args.step, args.every_term)
    np.savez_compressed(args.out, **{k: np.asarray(v) for k, v in out.items()})
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes", flush=True)


if __name__ == "__main__":
    main()
