"""Reservoir scan: mp3tpu_torch.ops.resv against mp3tpu.ops.jaxresv,
exactly, including padded (invalid) frames and a carried level."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp3tpu.ops import jaxresv
from mp3tpu_torch.ops import resv

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

CASES = [
    # seed, frames, nch, mode_gr, mean_bits, resv_max, delta, size0, valid
    (0, 200, 2, 2, 3080, 4088, 28, 0, "all"),
    (1, 150, 1, 2, 1460, 4088, 28, 512, "tail"),
    (2, 128, 2, 2, 3081, 4088, 12, 1024, "tail"),
    (3, 100, 2, 2, 3080, 4088, 0, 200, "holes"),
    (4, 60, 2, 2, 3080, 0, 28, 0, "tail"),
]


@pytest.mark.parametrize("seed,nframes,nch,mode_gr,mean_bits,resv_max,"
                         "delta,size0,valid", CASES,
                         ids=[f"case{c[0]}-{c[-1]}" for c in CASES])
def test_scan_matches_jax(seed, nframes, nch, mode_gr, mean_bits, resv_max,
                          delta, size0, valid):
    rng = np.random.RandomState(seed)
    G = nframes * mode_gr
    pe = rng.uniform(0, 3000, (nch, G)).astype(np.float32)
    demand = rng.randint(0, 4096, (nch, G)).astype(np.int32)
    if valid == "all":
        vf = np.ones(nframes, bool)
    elif valid == "tail":
        vf = np.arange(nframes) < nframes - 23
    else:
        vf = rng.rand(nframes) < 0.8

    bud_j, size_j = jaxresv.scan_budgets(
        jaxresv.granule_major(jnp.asarray(pe), nch, mode_gr),
        jaxresv.granule_major(jnp.asarray(demand), nch, mode_gr),
        jnp.int32(size0), mean_bits, resv_max, mode_gr, nch, delta,
        valid=jnp.asarray(vf))
    pe_g = resv.granule_major(torch.tensor(pe), nch, mode_gr)
    dm_g = resv.granule_major(torch.tensor(demand), nch, mode_gr)
    bud_t, size_t = resv.scan_budgets(pe_g, dm_g, size0, mean_bits,
                                      resv_max, mode_gr, nch, delta,
                                      valid=torch.tensor(vf))
    np.testing.assert_array_equal(np.asarray(bud_j, np.int64),
                                  bud_t.numpy().astype(np.int64))
    assert int(size_j) == size_t
    back = resv.from_granule_major(bud_t, nch, mode_gr).numpy()
    np.testing.assert_array_equal(
        np.asarray(jaxresv.from_granule_major(bud_j, nch, mode_gr),
                   np.int64), back.astype(np.int64))
