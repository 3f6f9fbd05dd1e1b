"""Train and eval steps: synthetic, combined self-supervised, real-only, eval.

Counterpart of ``spherehand_tpu/train/steps.py:build_steps`` (reference
network/engine.py:150-436). A step renders its synthetic batch on the
device (sampler -> FK -> raster -> noise -> GT heatmaps), runs the hourglass
on the synthetic batch and the flattened real multi-view batch together,
assembles the multi-task loss (the mutual-projection term through the fused
sphere op and its CUDA kernels), backpropagates and takes one Adam step.

- Optimizer: ``torch.optim.Adam(weight_decay=)``, which adds the L2 term to
  the gradient before the moments, as ``optax.add_decayed_weights`` ahead of
  ``scale_by_adam`` (steps.py:75-79); eps 1e-8 as optax. The learning rate
  is set on every call, so a caller drives the StepLR schedule
  (``EngineConfig.lr_at_epoch``).
- Init: conv kernels variance-scaling(1/3, fan_in, uniform), biases zero,
  GroupNorm 1 / 0, as the JAX network (models/hourglass.py:28-34).
- Draws: every stochastic input comes from :func:`StepFns.draw` with a
  ``torch.Generator`` (poses, synthesis draws with the pixel noise, resize
  scales, VAE noise, and with ``cfg.depth_resample`` the pixel-dropout
  uniforms, drawn last and only then, so the other draws do not move); the
  step functions are deterministic in them. ``combined_grads`` and
  ``combined_term_diag`` also take a ready synthetic batch (``synt=``).
- ``depth_resample`` (``cfg.depth_resample`` 3 or 5) drops and blurs the
  synthetic depth of the synthetic and combined steps and the real batch of
  the combined and real-only steps, where the JAX steps apply it
  (steps.py:151-161,201-207,290-296,391-395); never the eval step's.
- State: the network and optimizer update in place (PyTorch's way; the JAX
  step returns new buffers); each step returns the state it was given.
- Precision: the train steps run at PyTorch's float32 defaults (cuDNN
  convolutions may use TF32 on the GPU); the eval step honours
  ``cfg.eval_precision`` through ``infer.float32_precision``. ``cfg.bf16``
  computes the network's convolutions in bfloat16 (a module dtype,
  ``models/hourglass.py``), as the JAX ``make_network(dtype=bfloat16)``:
  parameters, Adam state, heads, the loss stack and every geometry op stay
  float32; under ``eval_precision="highest"`` the eval step computes the
  convolutions in float32 too (the JAX ``eval_network``).

Data parallelism (``group``, a ``parallel.mesh.RankGroup``): parameters
and Adam state are replicated (``init_state`` broadcasts rank 0's and checks
that every rank drew the same). Every rank draws the step's draws for the
whole batch from the same generator state, pads them like the rows (rows
repeated from the batch's start at weight 0) and keeps its own contiguous
block before rendering, so a rank renders only its synthetic rows. Each
weighted mean divides by the batch's global row count (``RealBatch.total``,
``StepDraws.synt_rows``), which makes a rank's loss its exact share of the
global loss; the gradients and the logged metrics are then summed over the
ranks (one flattened ``all_reduce`` each in the step). N ranks see the rows,
draws and weights of one. Where the JAX package draws its synthetic pad rows
fresh (``synt_pad``), the port repeats rows; both weigh them 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch import nn

from spherehand_torch.constants import Constants
from spherehand_torch.data.noise import (
    ResizeDraws,
    depth_resample,
    draw_depth_resample,
    draw_resize_scales,
    resize_scales,
)
from spherehand_torch.data.sampler import sample_poses
from spherehand_torch.data.synthesizer import (
    SynthesisDraws,
    SyntheticBatch,
    draw_synthesis,
    synthesize_from_draws,
)
from spherehand_torch.device import resolve_device
from spherehand_torch.evaluation.metrics import average_joint_error
from spherehand_torch.hand.assets import HandModel, load_hand_model
from spherehand_torch.infer import float32_precision
from spherehand_torch.losses.multitask import combine_loss, multitask_loss
from spherehand_torch.models.estimator import forward, make_network
from spherehand_torch.models.pose_denoiser import load_pose_denoiser
from spherehand_torch.models.pose_vae import draw_vae_noise, load_pose_vae_model
from spherehand_torch.ops.reduce import bmean
from spherehand_torch.parallel.mesh import RankGroup, RankRows, sample_rows
from spherehand_torch.train.config import EngineConfig

_C = Constants()
NUM_VIEWS = 3  # views per real sample (the NYU rig; steps.py:134 of the JAX package)
RESAMPLE_RATIO = 0.95  # depth_resample's kept share (steps.py:104 of the JAX package)


@dataclasses.dataclass
class TrainState:
    step: int
    network: nn.Module
    optimizer: torch.optim.Optimizer
    # Carried state of the temporal-smoothness loss (util_modules.py:360-381).
    prev_skel: torch.Tensor  # (V, 41, 3)
    has_prev: torch.Tensor   # bool scalar


class RealBatch(NamedTuple):
    """One multi-view batch (depth in mm, as a loader gives it). ``weights``
    (B,) marks padded rows with 0; None = all rows real. ``total``: on one
    rank of several, the global batch's count of true samples."""

    dms: torch.Tensor        # (B, V, 64, 64) mm, background 100
    gt_joints: torch.Tensor  # (B, V, 36, 3)
    poses: torch.Tensor      # (B, V, 4, 4)
    inv_poses: torch.Tensor  # (B, V, 4, 4)
    weights: torch.Tensor | None = None
    total: int | None = None


class StepDraws(NamedTuple):
    """The random inputs of one step (None where the step has no such part)."""

    poses: torch.Tensor | None             # (Bs, 26) sampler poses
    synthesis: SynthesisDraws | None       # scale, focal jitter, pixel noise
    resize: ResizeDraws | None             # resize-crop draws, (Br*V,)
    vae_noise: tuple | None                # per stack, (Br*V, 32)
    resample_real: torch.Tensor | None = None  # (Br*V, 64, 64) dropout uniforms
    resample_synt: torch.Tensor | None = None  # (Bs, 64, 64)
    # On one rank of several: the rank's synthetic rows (the draws above
    # are already those rows); None on one device.
    synt_rows: RankRows | None = None

    def to(self, device) -> "StepDraws":
        """The same draws on ``device``."""
        return _map_tensors(self, lambda x: x.to(device))

    def take(self, synt_idx: torch.Tensor | None, real_idx: torch.Tensor | None) -> "StepDraws":
        """The draws of the rows ``synt_idx`` (synthetic) and ``real_idx``
        (flat real rows); the resize coin, one for the batch, stays."""

        def rows(idx):
            return lambda x: x if x.dim() == 0 else x[idx]

        synt, real = rows(synt_idx), rows(real_idx)
        return self._replace(
            poses=_map_tensors(self.poses, synt), synthesis=_map_tensors(self.synthesis, synt),
            resample_synt=_map_tensors(self.resample_synt, synt),
            resize=_map_tensors(self.resize, real), vae_noise=_map_tensors(self.vae_noise, real),
            resample_real=_map_tensors(self.resample_real, real))


def _map_tensors(x, fn):
    """``x`` with ``fn`` applied to every tensor in it (nested tuples)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if not isinstance(x, tuple):
        return x
    items = [_map_tensors(v, fn) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


class StepFns(NamedTuple):
    init_state: Any      # (generator) -> TrainState
    draw: Any            # (generator, synt=True, real=True, real_rows=None) -> StepDraws
    synt_step: Any       # (state, lr, draws) -> (state, metrics)
    combined_step: Any   # (state, lr, draws, batch, is_mv) -> (state, metrics, vis)
    combined_grads: Any  # (state, draws, batch, is_mv, real_aug=True, synt=None)
    #                      -> (loss, terms, {parameter name: gradient})
    combined_term_diag: Any  # (state, draws, batch, is_mv, real_aug=True, synt=None)
    #                          -> flat dict of scalars
    real_step: Any       # (state, lr, draws, batch) -> (state, metrics, vis)
    eval_step: Any       # (state, draws, batch) -> (metrics, denoised view-0 joints)


@torch.no_grad()
def init_like_jax(network: nn.Module, generator: torch.Generator) -> nn.Module:
    """Conv kernels U(-sqrt(1/fan_in), sqrt(1/fan_in)) (flax
    variance_scaling(1/3, "fan_in", "uniform"), torch Conv2d's default
    kernel distribution), conv biases 0, GroupNorm scale 1 and bias 0."""
    for module in network.modules():
        if isinstance(module, nn.Conv2d):
            w = module.weight
            limit = math.sqrt(1.0 / (w.shape[1] * w.shape[2] * w.shape[3]))
            u = torch.rand(w.shape, generator=generator, device=generator.device)
            w.copy_(u * (2.0 * limit) - limit)
            module.bias.zero_()
        elif isinstance(module, nn.GroupNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return network


@contextlib.contextmanager
def _conv_dtype(network: nn.Module, dtype: torch.dtype):
    """Compute ``network``'s convolutions in ``dtype`` for the duration."""
    saved = network.dtype
    network.set_dtype(dtype)
    try:
        yield
    finally:
        network.set_dtype(saved)


def _global_dot(a: list[torch.Tensor], b: list[torch.Tensor]) -> torch.Tensor:
    """<a, b> over lists of float32 tensors, accumulated in float64 and
    returned in float32 (float32 sums over the network's 2.3M parameters
    drift by 1e-5 to 1e-4)."""
    return sum((x.double() * y.double()).sum() for x, y in zip(a, b)).float()


def _global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of a list of tensors (``optax.global_norm``)."""
    return torch.sqrt(sum((x.double() ** 2).sum() for x in tensors)).float()


@torch.no_grad()
def adam_direction_norm(optimizer: torch.optim.Adam, grads: dict) -> torch.Tensor:
    """Global norm of the Adam direction that ``grads`` ({parameter:
    gradient}) would take at the optimizer's current state, the state left
    as it is: ``optax.add_decayed_weights`` -> ``scale_by_adam`` (the moments
    updated with the gradient plus weight decay, bias-corrected at count + 1,
    eps 1e-8), without the learning rate."""
    directions = []
    for group in optimizer.param_groups:
        beta1, beta2 = group["betas"]
        for p in group["params"]:
            g = grads[p] + group["weight_decay"] * p
            st = optimizer.state.get(p, {})
            count = float(st.get("step", 0.0)) + 1.0
            m = beta1 * st.get("exp_avg", torch.zeros_like(p)) + (1 - beta1) * g
            v = beta2 * st.get("exp_avg_sq", torch.zeros_like(p)) + (1 - beta2) * g * g
            directions.append(
                (m / (1 - beta1 ** count)) / (torch.sqrt(v / (1 - beta2 ** count)) + group["eps"]))
    return _global_norm(directions)


def build_steps(cfg: EngineConfig, hand: HandModel | None = None,
                device: torch.device | str | None = None,
                group: RankGroup | None = None) -> StepFns:
    """The step functions for ``cfg`` on ``device`` (CUDA by default; the
    hand model's device when one is given; the mesh ``cfg.mesh`` names when
    none is). ``group``: this process's rank of a data-parallel group (its
    device by default); None trains on one device."""
    if device is None and group is not None and hand is None:
        device = group.device
    dev = hand.kp_radius.device if hand is not None and device is None else resolve_device(device)
    if hand is None:
        hand = load_hand_model(device=dev, lite=cfg.mesh == "lite")
    loss_cfg = cfg.loss_config
    vae = load_pose_vae_model(device=dev) if cfg.prior else None
    denoiser = load_pose_denoiser(device=dev)
    radii = hand.kp_radius
    eval_precision = "highest" if cfg.eval_precision == "highest" else None
    num_real_rows = cfg.real_batch * NUM_VIEWS
    net_dtype = torch.bfloat16 if cfg.bf16 else torch.float32

    def _row_weights(rows: RankRows | None) -> tuple[torch.Tensor | None, int | None]:
        """(weights on the device, global total) of a rank's rows."""
        if rows is None or rows.weights is None:
            return None, None if rows is None else rows.total
        return group.weights_on_device(rows), rows.total

    def _global(metrics: dict) -> dict:
        return metrics if group is None else group.sum_metrics(metrics)

    def init_state(generator: torch.Generator) -> TrainState:
        network = init_like_jax(make_network(cfg.num_stacks, dtype=net_dtype), generator).to(dev)
        if group is not None:
            _replicate(network)
        optimizer = torch.optim.Adam(network.parameters(), lr=cfg.lr,
                                     weight_decay=cfg.weight_decay)
        return TrainState(
            step=0, network=network, optimizer=optimizer,
            prev_skel=torch.zeros((NUM_VIEWS, _C.num_joints, 3), device=dev),
            has_prev=torch.zeros((), dtype=torch.bool, device=dev),
        )

    @torch.no_grad()
    def _replicate(network: nn.Module) -> None:
        """Rank 0's parameters on every rank, and a check that every rank
        had drawn them already (the same CPU generator seed)."""
        params = list(network.parameters())
        own = [p.detach().clone() for p in params]
        group.broadcast_(params)
        if not all(torch.equal(a, p) for a, p in zip(own, params)):
            raise RuntimeError(f"rank {group.rank} initialised other parameters than rank 0")

    def draw(generator: torch.Generator, synt: bool = True, real: bool = True,
             real_rows: int | None = None) -> StepDraws:
        """The draws of one step. ``real_rows`` is the flat real batch
        (batch x views) they are drawn for: ``None`` is the combined
        step's ``real_batch x NUM_VIEWS``; the real-only and eval steps
        draw for the batch they are given (``eval_batch x NUM_VIEWS`` in
        the engine). The resample draws come last, and only with
        ``cfg.depth_resample``. Under a group, the draws are those of the
        whole batch (``real_rows`` counts the global batch), padded and
        cut to this rank's rows."""
        rows = num_real_rows if real_rows is None else real_rows
        poses = sample_poses(generator, cfg.synt_batch) if synt else None
        synthesis = draw_synthesis(generator, cfg.synt_batch) if synt else None
        resize = draw_resize_scales(generator, rows) if real else None
        noise = (tuple(draw_vae_noise(generator, rows) for _ in range(cfg.num_stacks))
                 if real and cfg.prior else None)
        resample = cfg.depth_resample != 0
        rs_real = draw_depth_resample(generator, rows) if resample and real else None
        rs_synt = draw_depth_resample(generator, cfg.synt_batch) if resample and synt else None
        draws = StepDraws(poses, synthesis, resize, noise, rs_real, rs_synt)
        if group is None:
            return draws
        synt_rows = group.rows(cfg.synt_batch) if synt else None
        real_idx = sample_rows(group.rows(rows // NUM_VIEWS), NUM_VIEWS) if real else None
        if group.world == 1:  # the whole batch: no gather
            return draws._replace(synt_rows=synt_rows)

        def on_dev(idx):
            return None if idx is None else torch.as_tensor(idx, device=dev)

        return draws.take(on_dev(None if synt_rows is None else synt_rows.index),
                          on_dev(real_idx))._replace(synt_rows=synt_rows)

    def _resample(dms: torch.Tensor, uniforms: torch.Tensor | None) -> torch.Tensor:
        if not cfg.depth_resample:
            return dms
        flat = dms.reshape(-1, *dms.shape[-2:])
        return depth_resample(flat, uniforms, RESAMPLE_RATIO, cfg.depth_resample).reshape(dms.shape)

    def _synt(draws: StepDraws, synt: SyntheticBatch | None) -> SyntheticBatch:
        if synt is None:
            synt = synthesize_from_draws(hand, draws.poses, draws.synthesis, add_noise=True)
        return synt._replace(dms=_resample(synt.dms, draws.resample_synt))

    def _scaled_real(draws: StepDraws, batch: RealBatch) -> torch.Tensor:
        return _resample(batch.dms * _C.depth_scale, draws.resample_real)

    def _real_target(batch: RealBatch) -> dict:
        return {"real_dms": batch.dms, "camera_poses": batch.poses,
                "inv_camera_poses": batch.inv_poses}

    def _terms(state, synt, batch, scaled_real, scales, draws, is_mv):
        out = forward(state.network, synt_dms=None if synt is None else synt.dms,
                      real_dms=scaled_real, scales=scales)
        synt_w, synt_total = _row_weights(draws.synt_rows)
        terms, _, new_prev = multitask_loss(
            loss_cfg, out, radii, vae=vae, synt_target=synt,
            real_target=None if batch is None else _real_target(batch),
            vae_noise=draws.vae_noise, is_mv=is_mv,
            prev_skel=state.prev_skel, has_prev=state.has_prev,
            real_weights=None if batch is None else batch.weights,
            synt_weights=synt_w, real_total=None if batch is None else batch.total,
            synt_total=synt_total, group=group,
        )
        return terms, out, new_prev

    def _loss(state, synt, batch, scaled_real, scales, draws, is_mv):
        terms, out, new_prev = _terms(state, synt, batch, scaled_real, scales, draws, is_mv)
        return combine_loss(terms), terms, out, new_prev

    def _backward(state, loss):
        state.network.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            group.sum_grads(state.network.parameters())

    def _apply_updates(state, lr, new_prev=None):
        for group in state.optimizer.param_groups:
            group["lr"] = float(lr)
        state.optimizer.step()
        state.step += 1
        if new_prev is not None and new_prev[0] is not None:
            state.prev_skel, state.has_prev = new_prev
        return state

    def _metrics(loss, terms) -> dict:
        return {"loss": loss.detach(), **{k: v.detach() for k, v in terms.items()}}

    def synt_step(state: TrainState, lr: float, draws: StepDraws,
                  synt: SyntheticBatch | None = None):
        """Synthetic-only pretraining step (engine.py:265-316). ``synt``: a
        synthetic batch to train on in place of the one ``draws`` render."""
        synt = _synt(draws, synt)
        loss, terms, out, _ = _loss(state, synt, None, None, None, draws, True)
        _backward(state, loss)
        _apply_updates(state, lr)
        metrics = _metrics(loss, terms)
        metrics["synt_joint_err"] = bmean(
            torch.linalg.norm(out.synt_xyz[-1].detach() - synt.xyz, dim=-1),
            *_row_weights(draws.synt_rows))
        return state, _global(metrics)

    def _combined_inputs(draws, batch, real_aug, synt):
        synt = _synt(draws, synt)
        scales = resize_scales(draws.resize) if real_aug else None
        return synt, _scaled_real(draws, batch), scales

    def _combined(state, draws, batch, is_mv, real_aug, synt):
        synt, scaled_real, scales = _combined_inputs(draws, batch, real_aug, synt)
        loss, terms, out, new_prev = _loss(state, synt, batch, scaled_real, scales, draws, is_mv)
        _backward(state, loss)
        return loss, terms, out, new_prev, synt, scaled_real

    def combined_grads(state: TrainState, draws: StepDraws, batch: RealBatch, is_mv,
                       real_aug: bool = True, synt: SyntheticBatch | None = None):
        """(loss, terms, gradients by parameter name) of the combined
        objective, no optimizer update. ``real_aug=False`` bypasses the
        resize-crop augmentation."""
        loss, terms, *_ = _combined(state, draws, batch, is_mv, real_aug, synt)
        grads = {name: p.grad for name, p in state.network.named_parameters()}
        values = _global(_metrics(loss, terms))
        return values.pop("loss"), values, grads

    def combined_term_diag(state: TrainState, draws: StepDraws, batch: RealBatch, is_mv,
                           real_aug: bool = True, synt: SyntheticBatch | None = None) -> dict:
        """Per-term gradient attribution of the combined objective
        (steps.py:263-350 of the JAX package): one forward, then one
        backward per loss term (``torch.autograd.grad``, the graph kept).
        A flat dict of 0-d tensors: ``<term>/value``, ``<term>/grad_norm``
        (the global L2 norm of that term's parameter gradient alone) and
        ``<term>/cos_total`` (its cosine with the total gradient), plus
        ``total_grad_norm``, ``update_norm`` (the global norm of the Adam
        direction at the current optimizer state, the state unchanged; the
        applied step is lr x this) and ``param_norm``. The total is the sum
        of the terms' gradients. No parameter's ``.grad`` is touched."""
        synt, scaled_real, scales = _combined_inputs(draws, batch, real_aug, synt)
        terms, _, _ = _terms(state, synt, batch, scaled_real, scales, draws, is_mv)
        params = list(state.network.parameters())
        names = sorted(terms)
        grads_of = {}
        for i, name in enumerate(names):
            term = terms[name]
            if term.requires_grad:
                grads = torch.autograd.grad(term, params, retain_graph=i < len(names) - 1,
                                            allow_unused=True)
            else:
                grads = (None,) * len(params)
            grads_of[name] = [torch.zeros_like(p) if g is None else g
                              for p, g in zip(params, grads)]
            if group is not None:
                grads_of[name] = group.sum_tensors(grads_of[name])
        terms = _global({k: v.detach() for k, v in terms.items()})
        total = [sum(grads_of[name][k] for name in names) for k in range(len(params))]
        total_norm = _global_norm(total)
        diag = {"total_grad_norm": total_norm}
        for name in names:
            g = grads_of[name]
            n = _global_norm(g)
            diag[f"{name}/value"] = terms[name]
            diag[f"{name}/grad_norm"] = n
            diag[f"{name}/cos_total"] = _global_dot(g, total) / (n * total_norm + 1e-30)
        diag["update_norm"] = adam_direction_norm(state.optimizer, dict(zip(params, total)))
        diag["param_norm"] = _global_norm([p.detach() for p in params])
        return diag

    def combined_step(state: TrainState, lr: float, draws: StepDraws, batch: RealBatch, is_mv,
                      synt: SyntheticBatch | None = None):
        """Mixed synthetic + real self-supervised step (engine.py:318-436).
        ``synt``: as ``synt_step``'s."""
        loss, terms, out, new_prev, synt, scaled_real = _combined(
            state, draws, batch, is_mv, True, synt)
        _apply_updates(state, lr, new_prev)
        metrics = _metrics(loss, terms)
        metrics["avg_joint_error"] = average_joint_error(
            batch.gt_joints, out.real_xyz[-1].detach(), weights=batch.weights, total=batch.total)
        vis = {
            "real_dms": scaled_real,
            "real_uv_hms": out.real_uv_hms[-1].detach(),
            "real_xyz": out.real_xyz[-1].detach(),
            "synt_dms": synt.dms,
            "synt_uv_hms": out.synt_uv_hms[-1].detach(),
            "synt_xyz": out.synt_xyz[-1].detach(),
            "synt_gt_uv_hms": synt.uv_hms,
            "synt_gt_xyz": synt.xyz,
        }
        return state, _global(metrics), vis

    def real_step(state: TrainState, lr: float, draws: StepDraws, batch: RealBatch):
        """Real-data-only self-supervised step (engine.py:150-263, Train mode)."""
        scales = resize_scales(draws.resize)
        scaled_real = _scaled_real(draws, batch)
        loss, terms, out, new_prev = _loss(state, None, batch, scaled_real, scales, draws, True)
        _backward(state, loss)
        _apply_updates(state, lr, new_prev)
        metrics = _metrics(loss, terms)
        metrics["avg_joint_error"] = average_joint_error(
            batch.gt_joints, out.real_xyz[-1].detach(), weights=batch.weights, total=batch.total)
        vis = {"real_dms": scaled_real, "real_uv_hms": out.real_uv_hms[-1].detach(),
               "real_xyz": out.real_xyz[-1].detach()}
        return state, _global(metrics), vis

    @torch.no_grad()
    def eval_step(state: TrainState, draws: StepDraws, batch: RealBatch):
        """Losses for logging plus the headline metric: view 0, last stack,
        palm joints denoised (engine.py:203-207).

        It carries no temporal state, as the JAX eval step passes none: with
        ``temporal`` on, rows 1..B-1 are measured against their
        predecessors and row 0 against nothing (a zero skeleton, no
        previous batch), whatever the train state carries. Its input is
        never resampled. Under a group it returns the rank's rows' joints
        and the global metrics."""
        eval_dtype = torch.float32 if eval_precision else state.network.dtype
        with float32_precision(eval_precision), _conv_dtype(state.network, eval_dtype):
            scaled_real = batch.dms * _C.depth_scale
            out = forward(state.network, real_dms=scaled_real)
            last = out.real_xyz[-1]
            terms, _, _ = multitask_loss(
                loss_cfg, out, radii, vae=vae, real_target=_real_target(batch),
                vae_noise=draws.vae_noise, is_mv=True,
                prev_skel=torch.zeros(last.shape[1:], dtype=last.dtype, device=last.device),
                has_prev=torch.zeros((), dtype=torch.bool, device=last.device),
                real_weights=batch.weights, real_total=batch.total, group=group,
            )
            est = out.real_xyz[-1][:, 0]  # (B, 41, 3), view 0
            denoised = denoiser(est)
        metrics = dict(terms)
        metrics["avg_joint_error"] = average_joint_error(
            batch.gt_joints[:, 0], denoised, weights=batch.weights, total=batch.total)
        metrics["avg_joint_error_raw"] = average_joint_error(
            batch.gt_joints[:, 0], est, weights=batch.weights, total=batch.total)
        return _global(metrics), denoised

    return StepFns(init_state, draw, synt_step, combined_step, combined_grads,
                   combined_term_diag, real_step, eval_step)
