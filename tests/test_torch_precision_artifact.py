"""The port's eval-precision record on the H100
(``tests/goldens/torch_precision_wobble.json``,
``python -m spherehand_torch.tools.measure_wobble``).

1,024 synthetic crops through the shipped one-stack network, as one
B = 1024 forward and as eight B = 128 forwards, in PyTorch's default mode
(cuDNN convolutions in TF32) and with TF32 off (``highest``, the mode of
the port's parity and eval paths). ``highest`` is held to the JAX record's
bars (``tests/test_precision_artifact.py``): the same crop's joints within
0.01 mm at most and 0.001 mm at the 99th percentile, whatever batch served
it. ``default``'s gaps and the cost ratios are recorded with no bar: TF32
on the card is not the TPU's bf16 passes.
"""
import json
import os

import numpy as np
import pytest

PATH = os.path.join(os.path.dirname(__file__), "goldens", "torch_precision_wobble.json")


@pytest.fixture(scope="module")
def art():
    with open(PATH) as f:
        return json.load(f)


def test_record_is_the_cards_with_the_jax_keys(art):
    with open(os.path.join(os.path.dirname(__file__), "goldens", "precision_wobble.json")) as f:
        assert set(json.load(f)) <= set(art)
    assert "H100" in art["backend"] and art["batches"] == [1024, 128]
    for mode in ("default", "highest"):
        r = art[mode]
        assert np.isfinite([r["max_mm"], r["mean_mm"], r["p99_mm"], r["b128_ms_device"],
                            r["b1024_ms_device"]]).all()
        assert r["b128_ms_device"] > 0 and r["b1024_ms_device"] > 0


def test_highest_is_batch_invariant(art):
    assert art["highest"]["max_mm"] < 0.01
    assert art["highest"]["p99_mm"] < 0.001
