"""The engine's single-card switches in the port, on the CPU, against the
JAX package: the lite mesh (``--mesh lite``), ``depth_resample``
(``--depth_resample 3|5``) and bfloat16 convolutions (``--bf16``)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spherehand_tpu.data import noise as jnoise  # noqa: E402
from spherehand_tpu.data.sampler import sample_poses as jsample_poses  # noqa: E402
from spherehand_tpu.hand.assets import load_hand_model as jload_hand_model  # noqa: E402
from spherehand_tpu.hand.kinematics import forward_kinematics as jfk  # noqa: E402
from spherehand_tpu.models import estimator as jest  # noqa: E402
from spherehand_tpu.models.hourglass import convert_torch_state  # noqa: E402
from spherehand_tpu.render import raster as jraster  # noqa: E402
from spherehand_torch.constants import Constants  # noqa: E402
from spherehand_torch.convert import load_hourglass  # noqa: E402
from spherehand_torch.data import pseudo_real  # noqa: E402
from spherehand_torch.data.noise import depth_resample, draw_depth_resample  # noqa: E402
from spherehand_torch.data.synthesizer import synthesize_from_draws  # noqa: E402
from spherehand_torch.hand.assets import load_hand_model  # noqa: E402
from spherehand_torch.losses.multitask import multitask_loss  # noqa: E402
from spherehand_torch.models.estimator import forward, make_network  # noqa: E402
from spherehand_torch.render import raster_cuda  # noqa: E402
from spherehand_torch.render.raster import render_depth_64  # noqa: E402
from spherehand_torch.train.config import EngineConfig  # noqa: E402
from spherehand_torch.train.steps import RESAMPLE_RATIO, RealBatch, build_steps  # noqa: E402

_C = Constants()
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: these tests run many small
    CPU ops, which a parallel region slows down when the suite's workers
    share the cores; the previous count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lite():
    return load_hand_model(device="cpu", lite=True)


@pytest.fixture(scope="module")
def full():
    return load_hand_model(device="cpu")


def test_lite_assets_equal_jax(lite):
    """Every field of the lite model equals JAX's ``load_hand_model(lite=True)``
    bit for bit, 1,700 faces against the full mesh's 3,382."""
    ref = jload_hand_model(lite=True)
    for field in ("vertices", "faces", "offset_mats", "inv_offset_mats", "skin_weights",
                  "skin_matrix", "skin_matrix_faces", "kp_local", "kp_bone", "kp_radius"):
        np.testing.assert_array_equal(getattr(lite, field).numpy(), np.asarray(getattr(ref, field)),
                                      err_msg=field)
    assert lite.num_faces == ref.num_faces == 1700
    assert lite.raster_valid_frac == ref.raster_valid_frac
    assert lite.right_hand == ref.right_hand
    assert load_hand_model(device="cpu").num_faces == 3382


def test_lite_render_matches_jax(lite):
    """The lite mesh's ``render_depth_64`` on the CPU against JAX's XLA render
    of the same transforms, held to the full mesh's bar
    (tests/test_torch_raster.py): the same coverage, median |diff| 0, under
    0.1 % of pixels off by more than 1 mm; no kernel launched."""
    jl = jload_hand_model(lite=True)
    tr = np.array(jax.jit(lambda key: jfk(jl, jsample_poses(key, 2)))(jax.random.key(11)))
    rand_f = np.asarray([0.95, 1.07], np.float32)
    ref = np.asarray(jraster.render_depth_64(jl, jnp.asarray(tr), jnp.asarray(rand_f),
                                             backend="xla"))
    raster_cuda.reset_launch_counts()
    ours = render_depth_64(lite, torch.from_numpy(tr), torch.from_numpy(rand_f)).numpy()
    assert ours.shape == (2, 64, 64) and ours.max() <= 100.0
    assert ((ours < 100.0) == (ref < 100.0)).all() and (ours < 100.0).mean() > 0.05
    d = np.abs(ours - ref)
    assert np.median(d) == 0.0 and (d > 1.0).mean() < 1e-3
    assert not any(raster_cuda.LAUNCHES.values())


@pytest.mark.parametrize("kernel_size", [3, 5])
def test_depth_resample_core_matches_jax(kernel_size):
    """The core on JAX's own ``_rowwise_uniform`` draws equals JAX's
    ``depth_resample`` within atol 1e-6, zero-padded borders included (the
    blur pulls a background border pixel below 1)."""
    rng = np.random.RandomState(kernel_size)
    dms = np.ones((3, 64, 64), np.float32)
    dms[:, 16:48, 20:44] = rng.uniform(0.2, 0.6, (3, 32, 24))
    key = jax.random.key(kernel_size)
    uniforms = np.array(jnoise._rowwise_uniform(key, dms.shape))
    ref = np.asarray(jnoise.depth_resample(key, jnp.asarray(dms), 0.95, kernel_size))
    ours = depth_resample(torch.from_numpy(dms), torch.from_numpy(uniforms), 0.95,
                          kernel_size).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    assert ours[:, 0, 32].max() < 0.9  # border pixels blur toward the zero padding


def test_depth_resample_draws_by_distribution():
    """Draws: (n, 64, 64) U[0, 1) on the generator's device, mean 0.5 and
    kept share 0.95 within 0.005 over 64 rows (4 sigma is 0.0023 / 0.0017),
    the same for the same seed; the core refuses other kernel sizes."""
    u = draw_depth_resample(torch.Generator().manual_seed(0), 64)
    assert u.shape == (64, 64, 64) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.005
    assert abs(float((u <= RESAMPLE_RATIO).float().mean()) - RESAMPLE_RATIO) < 0.005
    assert torch.equal(u, draw_depth_resample(torch.Generator().manual_seed(0), 64))
    with pytest.raises(ValueError, match="kernel_size"):
        depth_resample(torch.ones(1, 64, 64), u[:1], 0.95, 7)


def _fake_batch(seed, b=1):
    """A real batch as tests/test_term_diag.py makes it: a block of depth in
    each view, identity cameras."""
    rng = np.random.RandomState(seed)
    dms = np.full((b, 3, 64, 64), 100.0, np.float32)
    dms[:, :, 24:40, 24:40] = rng.uniform(20, 60, (b, 3, 16, 16))
    eye = torch.eye(4).expand(b, 3, 4, 4).contiguous()
    return RealBatch(torch.from_numpy(dms),
                     torch.from_numpy(rng.uniform(-80, 80, (b, 3, 36, 3)).astype(np.float32)),
                     eye, eye.clone())


def test_resample_reaches_the_steps_jax_puts_it_in(full):
    """With ``depth_resample`` 5: the combined step's and the real-only
    step's inputs are the resampled ones (the real batch scaled, flattened,
    resampled with the real draws; the synthetic batch with its own; the
    synthetic step shares that code, and tests/test_torch_cli.py runs it),
    and the eval step is the same bits as without it. With it off the
    draws are the same stream and carry no resample fields."""
    cfg = EngineConfig(synt_batch=2, real_batch=1, depth_resample=5)
    off = EngineConfig(synt_batch=2, real_batch=1)
    fns, fns_off = build_steps(cfg, hand=full), build_steps(off, hand=full)
    state = fns.init_state(torch.Generator().manual_seed(3))
    batch = _fake_batch(3)

    d_on, d_off = fns.draw(torch.Generator().manual_seed(7)), fns_off.draw(
        torch.Generator().manual_seed(7))
    assert d_off.resample_real is None and d_off.resample_synt is None
    assert d_on.resample_real.shape == (3, 64, 64) and d_on.resample_synt.shape == (2, 64, 64)
    for a, b in zip(d_on[:3], d_off[:3]):
        for x, y in zip(jax.tree.leaves(tuple(a)), jax.tree.leaves(tuple(b))):
            assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(d_on.vae_noise, d_off.vae_noise))

    def real_in(draws):
        flat = (batch.dms * _C.depth_scale).reshape(-1, 64, 64)
        return depth_resample(flat, draws.resample_real, RESAMPLE_RATIO, 5).reshape(1, 3, 64, 64)

    synt = synthesize_from_draws(full, d_on.poses, d_on.synthesis)
    _, _, vis = fns.combined_step(state, 1e-3, d_on, batch, True)
    assert torch.equal(vis["real_dms"], real_in(d_on))
    assert torch.equal(vis["synt_dms"], depth_resample(synt.dms, d_on.resample_synt,
                                                       RESAMPLE_RATIO, 5))
    d_real = fns.draw(torch.Generator().manual_seed(8), synt=False)
    assert d_real.resample_synt is None
    _, _, vis = fns.real_step(state, 1e-3, d_real, batch)
    assert torch.equal(vis["real_dms"], real_in(d_real))
    d_eval = fns.draw(torch.Generator().manual_seed(9), synt=False)
    on_metrics, _ = fns.eval_step(state, d_eval, batch)
    off_metrics, _ = fns_off.eval_step(state, d_eval._replace(resample_real=None), batch)
    assert all(torch.equal(v, off_metrics[k]) for k, v in on_metrics.items())


def _probe_dms():
    rng = np.random.RandomState(0)
    dms = np.ones((3, 64, 64), np.float32)
    dms[:, 20:44, 18:46] = rng.uniform(0.2, 0.6, (3, 24, 28))
    return dms


def test_bf16_network_computes_like_jax(goldens):
    """``make_network(1, dtype=bfloat16)`` against JAX's
    ``make_network(1, dtype=jnp.bfloat16)`` with the same converted
    parameters: heads and joints float32; mean |diff| of the heads and
    joints to JAX's bf16 within 1.5 x JAX's own bf16-vs-f32 mean gap
    (measured 1.2-1.3 x: two bf16 evaluations in different orders), and
    the port's bf16-vs-f32 gap 0.5-2 x JAX's (it does compute in bf16);
    ``set_dtype(float32)`` gives back the f32 network bit for bit."""
    params = convert_torch_state(dict(goldens("grad_parity_init")), num_stacks=1)
    dms = _probe_dms()
    ref = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        net = jest.make_network(1, dtype=dt)
        o = jax.jit(lambda p, x, net=net: jest.forward(net, p, synt_dms=x))(params, jnp.asarray(dms))
        ref[name] = [np.asarray(x[0]) for x in (o.synt_uv_hms, o.synt_d_hms, o.synt_xyz)]
    ours = {}
    net = load_hourglass(make_network(1, dtype=torch.bfloat16), params)
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32), ("bf16_again", torch.bfloat16)):
        net.set_dtype(dt)
        with torch.no_grad():
            o = forward(net, synt_dms=torch.from_numpy(dms))
        assert all(x[0].dtype == torch.float32 for x in (o.synt_uv_hms, o.synt_d_hms, o.synt_xyz))
        ours[name] = [x[0].numpy() for x in (o.synt_uv_hms, o.synt_d_hms, o.synt_xyz)]
    f32_net = load_hourglass(make_network(1), params)
    with torch.no_grad():
        o = forward(f32_net, synt_dms=torch.from_numpy(dms))
    assert all(np.array_equal(a, x[0].numpy()) for a, x in
               zip(ours["f32"], (o.synt_uv_hms, o.synt_d_hms, o.synt_xyz)))
    assert all(np.array_equal(a, b) for a, b in zip(ours["bf16"], ours["bf16_again"]))
    for i, label in enumerate(("uv heads", "depth heads", "joints")):
        jax_gap = np.abs(ref["bf16"][i] - ref["f32"][i]).mean()
        to_jax = np.abs(ours["bf16"][i] - ref["bf16"][i]).mean()
        own_gap = np.abs(ours["bf16"][i] - ours["f32"][i]).mean()
        assert to_jax <= 1.5 * jax_gap, (label, to_jax, jax_gap)
        assert 0.5 * jax_gap <= own_gap <= 2.0 * jax_gap, (label, own_gap, jax_gap)


def test_bf16_keeps_the_loss_stack_and_state_float32(full):
    """Under ``bf16`` the parameters, their gradients and the Adam moments
    are float32; the mutual projection, the consistency term and the bone
    and collision terms ``combined_grads`` computes are bit for bit what the
    float32 loss stack gives for the same joints (no autocast reaches them);
    the eval step under ``eval_precision="highest"`` computes in float32 and
    gives the network back in bf16."""
    cfg = EngineConfig(synt_batch=2, real_batch=1, bf16=True, eval_precision="highest",
                       prior=False)
    fns = build_steps(cfg, hand=full)
    gen = torch.Generator().manual_seed(5)
    state = fns.init_state(gen)
    batch = _fake_batch(5)
    draws = fns.draw(gen)
    synt = synthesize_from_draws(full, draws.poses, draws.synthesis)
    _, terms, _ = fns.combined_grads(state, draws, batch, True, real_aug=False, synt=synt)
    with torch.no_grad():
        out = forward(state.network, synt_dms=synt.dms, real_dms=batch.dms * _C.depth_scale)
    assert all(t.dtype == torch.float32 for field in ("synt_uv_hms", "real_d_hms", "real_xyz",
                                                      "real_latent") for t in getattr(out, field))
    ref, _, _ = multitask_loss(
        cfg.loss_config, out, full.kp_radius, synt_target=synt,
        real_target={"real_dms": batch.dms, "camera_poses": batch.poses,
                     "inv_camera_poses": batch.inv_poses},
        is_mv=True, prev_skel=state.prev_skel, has_prev=state.has_prev)
    for name in ("mv_projection", "mv_consistency", "bone_length", "collision", "synt_uv"):
        assert torch.equal(terms[name], ref[name]), name
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in state.network.parameters())
    state.optimizer.step()
    assert all(v.dtype == torch.float32 for s in state.optimizer.state.values()
               for k, v in s.items() if k != "step")
    metrics, _ = fns.eval_step(state, fns.draw(gen, synt=False), batch)
    assert state.network.dtype == torch.bfloat16
    f32 = build_steps(EngineConfig(synt_batch=2, real_batch=1, eval_precision="highest",
                                   prior=False), hand=full)
    state.network.set_dtype(torch.float32)
    ref_metrics, _ = f32.eval_step(state, fns.draw(gen, synt=False), batch)
    assert all(torch.equal(v, ref_metrics[k]) for k, v in metrics.items())


# bf16 against f32, the combined loss from the shipped weights on a rendered
# batch at 2 + 1 x 3: measured 4e-4 to 3.3e-3 on the CPU over four seeds;
# chip_smoke phase 13b holds the card to the same bound.
BF16_LOSS_REL = 2e-2


def test_bf16_combined_loss_stays_near_f32(full):
    """From the shipped weights on the same rendered real batch and draws
    (2 + 1 x 3), the bf16 combined loss is within ``BF16_LOSS_REL`` of the
    f32 one, and not equal to it (bf16 computes)."""
    from spherehand_torch.convert import train_state_from_params
    from spherehand_torch.infer import load_params_npz

    params = load_params_npz(os.path.join(ROOT, "assets", "pretrained", "synthetic_params.npz"))
    batch = RealBatch(*pseudo_real.render_multiview_batch(
        full, torch.Generator().manual_seed(0), 1)[:4])
    losses = []
    for bf16 in (False, True):
        fns = build_steps(EngineConfig(synt_batch=2, real_batch=1, bf16=bf16), hand=full)
        state = train_state_from_params(fns.init_state, params)
        loss, _, _ = fns.combined_grads(state, fns.draw(torch.Generator().manual_seed(10)),
                                        batch, True)
        losses.append(float(loss))
    gap = abs(losses[1] - losses[0]) / abs(losses[0])
    assert 0.0 < gap <= BF16_LOSS_REL, losses
