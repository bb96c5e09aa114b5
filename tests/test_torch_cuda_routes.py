"""The port's device routes on the GPU against the same code on the CPU.

The exact band (ops/banded_realign), the edit DP (ops/editdp), the exact
int8 products (ops/devmm), the
float32 significance (ops/hypergeom_device), the MaxCorrs device scan
and the resolver's device products run on CUDA tensors and on CPU
tensors, which tests/test_torch_{editdp,devmm,hypergeom,maxcorr,
resolver}.py hold to the JAX package. Integers (DP rows, alignments,
counts, subdivisions) must be equal (tolerance 0); float32 Z within
1e-5 relative (the card's float32 division and log may round in
another ulp than the CPU's), with identical MaxCorrs decisions. Marked
`cuda`: skipped, with the reason, where torch sees no GPU. The file
imports no jax:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_routes.py -q
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: these are the device routes")
    return torch.device("cuda", 0)


def _both(fn, dev, *arrays):
    """fn on CPU tensors and on CUDA tensors of the same numpy arrays."""
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return fn(*cpu), fn(*[t.to(dev) for t in cpu])


def test_exact_band_cuda_equals_cpu(dev):
    """banded_fill + entry_and_backtrack on CUDA tensors == on CPU
    tensors (which tests/test_torch_banded.py holds to the JAX
    package): codes, final band, rows, best and insert lists."""
    from repeatresolver_tpu_torch.ops import banded_realign as br
    rng = np.random.default_rng(8)
    b, c, l, w = 6, 700, 300, 48
    msa = rng.integers(0, 6, (b * 3, c)).astype(np.int8)
    counts = np.stack([(msa == s).sum(axis=0) for s in range(6)],
                      axis=1).astype(np.int32)
    seqs = rng.integers(0, 4, (b, l)).astype(np.int8)
    steps = rng.choice([0, 1, 1, 2, 7], (b, l)).astype(np.int32)
    ways = np.minimum(np.cumsum(steps, axis=1), c - 1).astype(np.int32)
    lengths = rng.integers(l // 2, l + 1, b).astype(np.int32)
    lengths[1] = 0
    for i in range(b):
        ways[i, lengths[i]:] = ways[i, max(lengths[i] - 1, 0)]
    anf = np.maximum(0, ways - w // 2).astype(np.int32)
    eb = np.maximum(-1, ways[np.arange(b), np.maximum(lengths - 1, 0)]
                    - w // 2).astype(np.int32)

    def run(counts, rows, seqs, ways, lengths, anf, eb):
        fill = br.banded_fill(counts, rows, seqs, ways, lengths, c,
                              bandwidth=w, chunk=128)
        return (*fill, *br.entry_and_backtrack(
            *fill, seqs, anf, eb, lengths, c, cpad=c, bandwidth=w))

    cpu, gpu = _both(run, dev, counts, msa[:b], seqs, ways, lengths, anf, eb)
    for x, y in zip(cpu, gpu, strict=True):
        assert torch.equal(x, y.cpu())
    assert int(cpu[-1].sum()) > 0         # some inserts


def test_editdp_cuda_equals_cpu(dev):
    from repeatresolver_tpu_torch.ops import editdp
    rng = np.random.default_rng(4)
    t = rng.integers(0, 4, 300).astype(np.int16)
    t[40:70] = 1                                    # homopolymer ties
    lens = np.array([200, 0, 1, 150, 200, 97], np.int32)
    q = np.full((6, 200), 100, np.int16)
    for r, n in enumerate(lens):
        src = t[r * 7:r * 7 + n].copy()
        mut = rng.random(n) < 0.15
        src[mut] = rng.integers(0, 4, mut.sum())
        q[r, :n] = src
    q[3, :150] = 1
    targets = np.stack([t] * 6)
    targets[2, 100:] = 200
    c, g = _both(editdp.last_rows, dev, q, lens, targets)
    assert torch.equal(c, g.cpu())
    (ac, fc), (ag, fg) = _both(editdp.align_on_device, dev, q, lens, t)
    assert torch.equal(ac, ag.cpu()) and torch.equal(fc, fg.cpu())
    assert (ac[1] == -1).all()


@pytest.mark.parametrize("m,n,k", [(1280, 1280, 13840), (5, 3, 7),
                                   (300, 120, 257), (17, 9, 0)])
def test_int_matmul_exact_on_cuda(dev, m, n, k):
    from repeatresolver_tpu_torch.ops import devmm
    rng = np.random.default_rng(k)
    a = (rng.random((m, k)) < 0.5).astype(np.int8)
    b = (rng.random((n, k)) < 0.5).astype(np.int8)
    out = devmm.int_matmul_t(torch.from_numpy(a).to(dev),
                             torch.from_numpy(b).to(dev))
    assert out.dtype == torch.int32 and out.shape == (m, n)
    ref = a.astype(np.int64) @ b.astype(np.int64).T
    np.testing.assert_array_equal(out.cpu().numpy().astype(np.int64), ref)


def test_significance_cuda_close_to_cpu(dev):
    from repeatresolver_tpu_torch.ops import hypergeom_device as hd
    rng = np.random.default_rng(2)
    nn = rng.integers(50, 4000, 20000)
    k = np.array([rng.integers(1, x) for x in nn])
    n = np.array([rng.integers(1, x) for x in nn])
    s = np.minimum(np.minimum(k, n), ((n + 1) * (k + 1)) // (nn + 2)
                   + rng.integers(0, 40, len(nn)))
    sz1, sz2 = n + 1, k + 2
    table = hd.log_factorial_table(int(nn.max()))

    def z(*a):
        lf = [torch.from_numpy(v).to(a[0].device) for v in table]
        return hd.positive_significance_f32(*a, *lf)
    zc, zg = _both(z, dev, *(v.astype(np.int32)
                             for v in (s, n, k, nn, sz1, sz2)))
    zg = zg.cpu()
    assert torch.equal(zc > 0, zg > 0)
    assert int((zc > 0).sum()) > 1000
    np.testing.assert_allclose(zg.numpy(), zc.numpy(), rtol=1e-5)


def _planted(rows=120, cols=700, seed=5):
    """test_golden_maxcorr's planted MSA, larger: 2 copy groups, six
    SNP columns, 2% noise, 3% gaps, ragged coverage."""
    rng = np.random.default_rng(seed)
    consensus = rng.integers(0, 4, cols)
    msa = np.tile(consensus, (rows, 1)).astype(np.int8)
    group = np.arange(rows) % 2
    for cc in (50, 90, 140, 200, 260, 330, 520, 640):
        msa[group == 1, cc] = (consensus[cc] + 1) % 4
    noise = rng.random((rows, cols)) < 0.02
    msa[noise] = rng.integers(0, 4, noise.sum())
    msa[rng.random((rows, cols)) < 0.03] = 4
    for r in range(rows):
        msa[r, :rng.integers(0, 25)] = 5
        msa[r, cols - rng.integers(0, 25):] = 5
    return msa


def test_maxcorr_scan_cuda_matches_cpu(dev):
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    msa = _planted()
    cfg = pmc.MaxCorrConfig(mincov=20)
    cpu = pmc.compute_maxcorrs_device(msa, cfg, tile=128, device="cpu")
    gpu = pmc.compute_maxcorrs_device(msa, cfg, tile=128, device=dev)
    cutoff = cfg.resolved_cutoff(msa.shape[1])
    np.testing.assert_array_equal(gpu > cutoff, cpu > cutoff)
    assert (cpu > cutoff).sum() >= 8
    np.testing.assert_allclose(gpu, cpu, rtol=1e-5, atol=1e-6)
    host = pmc.compute_maxcorrs(msa, cfg, fast=True)
    sig = host > cutoff
    np.testing.assert_array_equal(gpu > cutoff, sig)
    np.testing.assert_allclose(gpu[sig], host[sig], rtol=2e-3, atol=5e-3)


def test_resolver_cuda_products_byte_identical(dev, monkeypatch):
    from repeatresolver_tpu_torch.config import ResolverConfig
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    from repeatresolver_tpu_torch.models import resolver as pres
    from repeatresolver_tpu_torch.ops import devmm
    rng = np.random.default_rng(7)
    tpl = rng.integers(0, 4, 400)
    rows = []
    for _ in range(4):
        cp = tpl.copy()
        snps = rng.choice(400, 6, replace=False)
        cp[snps] = (cp[snps] + 1 + rng.integers(0, 3, 6)) % 4
        for _ in range(8):
            r = cp.copy()
            err = rng.random(400) < 0.05
            r[err] = rng.integers(0, 4, err.sum())
            rows.append(r)
    msa = np.array(rows, np.int8)
    mc = pmc.compute_maxcorrs(msa, pmc.MaxCorrConfig(mincov=8))
    cfg = ResolverConfig(cov=8)
    monkeypatch.setenv("RR_RESOLVER_DEVICE", "0")
    host = pres.resolve_window(msa, mc.copy(), 0, 399, cfg, dev)
    monkeypatch.delenv("RR_RESOLVER_DEVICE")
    monkeypatch.setenv("RR_DEVICE_MM_MIN", "0")
    calls = devmm.matmul_t.device_calls
    gpu = pres.resolve_window(msa, mc.copy(), 0, 399, cfg, dev)
    assert devmm.matmul_t.device_calls > calls
    assert host["Kmeans"].max() >= 1
    for k in host:
        np.testing.assert_array_equal(gpu[k], host[k], err_msg=k)
