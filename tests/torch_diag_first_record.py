"""Both packages' ``combined_term_diag`` on a batch of the port's recipe
data at the shipped weights: does JAX's code rank collision above the
mutual projection on the port's data, as the port's first diag record of the
divergence study on the H100 does (``goldens/torch_divergence_study.json``)?

The real batch is 25 hands (x 3 views, the recipe's batch) of the recipe's
writer: the port's pseudo-NYU writer on the CPU (``data.pseudo_real``, seed
0, the shifted sensor; the card's generator draws other hands from the same
seed, and the stock run's first batch takes shuffled rows of 72,192), read
back through the port's ``NyuDataset``. Both packages take the
same draws: JAX's from the engine's key of epoch 0, step 0 (the synthetic
batch, the resize-crop draws, the prior noise), handed to the port as
``test_torch_evidence._jax_step_draws`` does. The step is the stock probe's
first (``is_mv`` on, float32, TF32 does not arise on the CPU). Prints one
JSON line: each term's value, gradient norm and cosine with the total in
both packages, and which of collision and the mutual projection has the
larger cosine in each.

Run from the repository root (a few minutes, one process)::

    JAX_PLATFORMS=cpu python tests/torch_diag_first_record.py --work /tmp/diag1
"""
from __future__ import annotations

import argparse
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from spherehand_torch.convert import train_state_from_params  # noqa: E402
from spherehand_torch.data import pseudo_real  # noqa: E402
from spherehand_torch.data.nyu import NyuDataset  # noqa: E402
from spherehand_torch.infer import load_params_npz  # noqa: E402
from spherehand_torch.tools.selfsup_demo import PRETRAINED  # noqa: E402
from spherehand_torch.train.config import EngineConfig  # noqa: E402
from spherehand_torch.train.steps import RealBatch, build_steps  # noqa: E402
from spherehand_tpu.hand.assets import load_hand_model as jload_hand_model  # noqa: E402
from spherehand_tpu.train import steps as jax_steps  # noqa: E402
from spherehand_tpu.train.config import EngineConfig as JEngineConfig  # noqa: E402
from test_torch_evidence import _jax_step_draws  # noqa: E402

TERMS = ("collision", "mv_projection")


def _row(diag) -> dict:
    names = sorted(k.split("/")[0] for k in diag if k.endswith("/value"))
    return {n: {k: float(diag[f"{n}/{k}"]) for k in ("value", "grad_norm", "cos_total")}
            for n in names} | {"total_grad_norm": float(diag["total_grad_norm"])}


def diag_both(work: str, seed: int = 0) -> dict:
    torch.set_num_threads(1)
    cfg = EngineConfig()
    data = os.path.join(work, "train")
    if not os.path.exists(os.path.join(data, "mv_data_0_shape.pkl")):
        pseudo_real.generate_pseudo_nyu(data, cfg.real_batch, seed, "cpu")
    ds = NyuDataset(data)
    rows = np.arange(cfg.real_batch)
    dms, joints, poses, inv = (np.asarray(a, np.float32) for a in ds.gather(rows))
    t = torch.from_numpy
    batch = RealBatch(t(dms), t(joints), t(poses), t(inv))
    params = load_params_npz(PRETRAINED)

    jhand = jload_hand_model()
    jcfg = JEngineConfig(mode="Train", num_stacks=1, eval_precision="highest",
                         data_parallel=False)
    jfns = jax_steps.build_steps(jcfg, jhand)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_steps.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=jax_steps.make_optimizer(jcfg.weight_decay).init(jparams),
        prev_skel=jnp.zeros((3, 41, 3)), has_prev=jnp.zeros((), bool))
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 0), 0)
    jbatch = jax_steps.RealBatch(*(jnp.asarray(a) for a in (dms, joints, poses, inv)))
    jdiag = jax.jit(jfns.combined_term_diag)(jstate, key, jbatch, jnp.asarray(True))

    fns = build_steps(cfg, device="cpu")
    state = train_state_from_params(fns.init_state, params)
    synt, draws = _jax_step_draws(jhand, cfg.synt_batch, cfg.real_batch * 3)(key)
    pdiag = fns.combined_term_diag(state, draws, batch, True, synt=synt)

    out = {"jax_cpu": _row(jdiag), "port_cpu": _row(pdiag)}
    out["leads_by_cosine"] = {
        k: max(TERMS, key=lambda n: out[k][n]["cos_total"]) for k in out}
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--work", required=True, help="directory for the written hands")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    print(json.dumps(diag_both(args.work, args.seed)), flush=True)


if __name__ == "__main__":
    main()
