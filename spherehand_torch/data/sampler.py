"""Synthetic pose-parameter sampler: a draw step plus a deterministic mixer.

Counterpart of ``spherehand_tpu/data/sampler.py``. Following the port's RNG
rule, :func:`draw_pose_uniforms` makes every random draw from a
``torch.Generator`` and :func:`mix_poses` turns those draws into pose
vectors without randomness, so a test can feed the mixer the draws the JAX
sampler makes from its keys.

Distribution (reference dataset/joint_angle.py):
- palm: yaw/roll in [-pi, pi], pitch in [-pi, 0], translation xy +-15 mm,
  z in [-35, 15];
- coupled abduction: shared spread (U-0.35)/1.55 scaled per finger by
  [1.55, 0.75, -0.75, -2.2] plus +-5 deg jitter;
- five per-finger flex archetypes (straight/open/half-open/pinching/closed)
  with inter-phalange coupling, mixed by 10 hand modes;
- thumb: bimodal flex, flex2 = 0.25 flex1, flex3 in [-1.7, 0.3].
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

_DEG = math.pi / 180.0

# Per-finger abduction coupling: index, middle, ring, pinky.
_ABDUCT_COEF = (1.55, 0.75, -0.75, -2.2)
_FLEX_BASE = (-0.2, -0.4, -0.34)
# Three coupled stages spread a flex angle over the phalanges.
_COUPLE = ((1.0, 0.2, 0.0), (0.2, 1.0, 0.7), (0.0, 0.2, 1.0))  # (stage, phalange)
# Per-mode, per-finger archetype selector. Codes: 0-4 = fixed archetype,
# 5 = random-open, 6 = random-close, 7 = random-any.
_MODE_TABLE = (
    (0, 0, 0, 0),  # all straight
    (1, 1, 1, 1),  # all open
    (2, 2, 2, 2),  # all half-open
    (3, 3, 3, 3),  # all pinching
    (4, 4, 4, 4),  # all closed
    (5, 6, 6, 6),  # index open
    (6, 6, 6, 5),  # pinky open
    (5, 5, 6, 6),  # index & middle open
    (6, 5, 5, 5),  # middle & ring & pinky open
    (7, 7, 7, 7),  # fully random
)


class PoseDraws(NamedTuple):
    """Every random draw of one sampler batch, already in its range."""

    palm: torch.Tensor         # (B, 6): rx, pitch magnitude, rz, tx, ty, tz
    spread: torch.Tensor       # (B, 1) U[0, 1)
    jitter: torch.Tensor       # (B, 4) +-5 deg
    pert: torch.Tensor         # (B, 4, 3) +-10 deg
    big: torch.Tensor          # (B, 4, 3) [60, 90] deg
    small_tail: torch.Tensor   # (B, 4, 2) [5, 35] deg
    half_head: torch.Tensor    # (B, 4) [0, 30] deg
    straight: torch.Tensor     # (B, 4, 3)
    open_: torch.Tensor        # (B, 4, 3)
    mode: torch.Tensor         # (B,) int in [0, 10)
    open_pick: torch.Tensor    # (B, 4) int in [0, 3)
    close_pick: torch.Tensor   # (B, 4) int in [3, 5)
    any_pick: torch.Tensor     # (B, 4) int in [0, 5)
    thumb_bent: torch.Tensor   # (B,) bool
    thumb_flex_bent: torch.Tensor  # (B,) [-0.25, 0.10)
    thumb_flex_open: torch.Tensor  # (B,) [0.1, 0.7), same uniform as above
    thumb_abduct: torch.Tensor     # (B,) [-0.5, 0.5)
    thumb_flex3: torch.Tensor      # (B,) [-1.7, 0.3)


def draw_pose_uniforms(generator: torch.Generator, batch: int) -> PoseDraws:
    """Draw one batch of sampler inputs on the generator's device."""
    dev = generator.device

    def u(shape, lo, hi):
        r = torch.rand(shape, generator=generator, device=dev)
        return r * (hi - lo) + lo

    def randint(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    shape = (batch, 4)
    lo_hi = ((-3.14, 3.14), (0.0, 3.14), (-3.14, 3.14),
             (-15.0, 15.0), (-15.0, 15.0), (-35.0, 15.0))
    palm = torch.stack([u((batch,), lo, hi) for lo, hi in lo_hi], dim=-1)
    thumb_r = torch.rand((batch,), generator=generator, device=dev)
    return PoseDraws(
        palm=palm,
        spread=u((batch, 1), 0.0, 1.0),
        jitter=u(shape, -5 * _DEG, 5 * _DEG),
        pert=u(shape + (3,), -10 * _DEG, 10 * _DEG),
        big=u(shape + (3,), 60 * _DEG, 90 * _DEG),
        small_tail=u(shape + (2,), 5 * _DEG, 35 * _DEG),
        half_head=u(shape, 0.0, 30 * _DEG),
        straight=torch.stack(
            [u(shape, -0.25, 0.0), u(shape, -0.4, 0.0), u(shape, -0.34, 0.0)], dim=-1
        ),
        open_=torch.stack(
            [u(shape, -0.1, 0.15), u(shape, -0.1, 0.3), u(shape, -0.1, 0.24)], dim=-1
        ),
        mode=randint((batch,), 0, 10),
        open_pick=randint(shape, 0, 3),
        close_pick=randint(shape, 3, 5),
        any_pick=randint(shape, 0, 5),
        thumb_bent=u((batch,), 0.0, 1.0) < 0.5,
        thumb_flex_bent=thumb_r * 0.35 - 0.25,
        thumb_flex_open=thumb_r * 0.6 + 0.1,
        thumb_abduct=u((batch,), -0.5, 0.5),
        thumb_flex3=u((batch,), -1.7, 0.3),
    )


def mix_poses(d: PoseDraws) -> torch.Tensor:
    """Deterministic core: the draws -> (B, 26) pose parameter vectors."""
    dev = d.palm.device
    batch = d.palm.shape[0]
    palm = d.palm * torch.tensor([1.0, -1.0, 1.0, 1.0, 1.0, 1.0], device=dev)

    spread = (d.spread - 0.35) / 1.55
    abduct = torch.tensor(_ABDUCT_COEF, device=dev) * (spread + d.jitter)

    base = torch.tensor(_FLEX_BASE, device=dev)
    couple = torch.tensor(_COUPLE, device=dev)

    def mix(stages):  # (..., 3 stages) -> (..., 3 phalanges)
        return base + torch.einsum("...s,sp->...p", stages, couple)

    big = d.big + d.pert
    small_tail = d.small_tail + d.pert[..., 1:]
    half_head = d.half_head + d.pert[..., 0]
    closed = mix(big)
    pinching = mix(torch.cat([big[..., :1], small_tail], dim=-1))
    half_open = mix(torch.cat([half_head[..., None], big[..., 1:]], dim=-1))
    arch = torch.stack([d.straight, d.open_, half_open, pinching, closed], dim=-2)

    code = torch.tensor(_MODE_TABLE, device=dev)[d.mode]  # (B, 4)
    pick = torch.where(
        code < 5,
        code,
        torch.where(code == 5, d.open_pick,
                    torch.where(code == 6, d.close_pick, d.any_pick)),
    )
    flex = torch.take_along_dim(arch, pick[..., None, None], dim=-2)[..., 0, :]
    fingers = torch.cat([abduct[..., None], flex], dim=-1)  # (B, 4, 4)

    t_flex = torch.where(d.thumb_bent, d.thumb_flex_bent, d.thumb_flex_open)
    thumb = torch.stack([d.thumb_abduct, t_flex, 0.25 * t_flex, d.thumb_flex3], dim=-1)
    return torch.cat([palm, fingers.reshape(batch, 16), thumb], dim=-1)


def sample_poses(generator: torch.Generator, batch: int) -> torch.Tensor:
    """Draw a batch of 26-dim pose parameter vectors: (batch, 26)."""
    return mix_poses(draw_pose_uniforms(generator, batch))
