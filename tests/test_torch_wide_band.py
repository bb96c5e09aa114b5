"""Realign bands whose staircase window passes kernel A's MAX_W2, on the CPU.

Kernel A holds a window of at most `ops/cuda_realign.MAX_W2` = 4,096
lanes (its plain version keeps the same limit). The port's resident
engine caps a block's slack at the widest ladder rung whose window
bandwidth + widen * chunk fits, and sends a block whose drift no fitting
rung covers to the exact band, as `BatchedRealigner._realign_block`
does. The JAX resident engine has no such cap: it runs the staircase at
any window, Pallas in interpret mode here, as the JAX package's own
tests run it. The staircase equals the exact band for any covering
slack, so the two must give the same score log and the same final MSA
(exact equality).
"""
import numpy as np
import pytest
import torch

from repeatresolver_tpu.config import RealignerConfig as JCfg
from repeatresolver_tpu_torch.config import RealignerConfig
from tests.test_realigner_device import make_msa

torch.set_num_threads(1)


def drift_msa(seed=2, gap=1650):
    """4 rows: row 0 holds 90 bases, then 150 bases `gap` columns
    further on, so that its first chunk of 128 bases drifts by about
    gap + 80 columns (rung 16 of chunk 128 covers it, rung 12 does not);
    the other three rows cover every column."""
    rng = np.random.default_rng(seed)
    msa = np.full((4, 600 + gap), 5, np.int8)
    msa[:, :400] = make_msa(seed, rows=4, tlen=400)
    msa[0, :] = 5
    msa[0, 10:100] = rng.integers(0, 4, 90)
    msa[0, 100 + gap:250 + gap] = rng.integers(0, 4, 150)
    msa[1:, 400:] = rng.integers(0, 4, (3, gap + 200))
    return msa


@pytest.mark.parametrize("band,make,exact", [
    # the default slack 12 would make a window of 2600 + 12 x 128 = 4136
    (2600, lambda: make_msa(1, rows=4, tlen=400), False),
    # rung 12 fits (3636 lanes), rung 16 (4148) does not, and row 0's
    # drift needs rung 16
    (2100, drift_msa, True),
])
def test_wide_band_matches_jax_resident(band, make, exact):
    from repeatresolver_tpu.models import realigner as jr
    from repeatresolver_tpu_torch.models import realigner as pr
    from repeatresolver_tpu_torch.models.realigner import (
        BatchedRealigner, chunk_drift, compact_rows)
    from repeatresolver_tpu_torch.models.realigner_device import (
        DeviceResidentRealigner,
    )
    from repeatresolver_tpu_torch.ops import cuda_realign as cr
    msa = make()
    assert band + 16 * 128 > cr.MAX_W2
    _, ways, _ = compact_rows(msa)
    drift = chunk_drift(ways, 128)
    assert (drift > 12 * 128) == exact
    assert drift <= BatchedRealigner.WIDEN_LADDER[-1] * 128
    log_j: list = []
    out_j = jr.realign_batched(
        msa.copy(), JCfg(bandwidth=band, block_rows=4, max_rounds=2),
        score_log=log_j, mode="staircase", kernel="pallas")
    n_exact = DeviceResidentRealigner.exact_blocks_run["native"]
    log_p: list = []
    out_p = pr.realign_batched(
        msa.copy(), RealignerConfig(bandwidth=band, block_rows=4,
                                    max_rounds=2),
        score_log=log_p, device="cpu", validate=True)
    assert log_p == log_j
    np.testing.assert_array_equal(out_p, out_j)
    assert (DeviceResidentRealigner.exact_blocks_run["native"]
            > n_exact) == exact
