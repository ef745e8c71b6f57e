"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Run on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Exact on integer-valued data; rtol 1e-5 / atol 1e-4 on gaussian data,
where the kernels sum in another order than the plain versions.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU or interpret mode")
    return torch.device("cuda")


def _data(shape, integer, seed, dev):
    r = np.random.default_rng(seed)
    x = r.normal(size=shape).astype(np.float32)
    if integer:
        x = np.clip(np.round(x * 2), -4, 4).astype(np.float32)
    return torch.from_numpy(x).to(dev)


def _check(got, want, integer):
    if integer:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(37, 91, 50), (200, 1000, 128)])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("kernel", ["l2", "ip"])
def test_pairwise_kernel_matches_plain(card, shape, integer, kernel):
    from repro_torch.kernels import l2_distance as l2
    nq, nx, d = shape
    q = _data((nq, d), integer, 1, card)
    x = _data((nx, d), integer, 2, card)
    before = l2.LAUNCHES
    got = l2.pairwise_distance(q, x, kernel=kernel)
    assert l2.LAUNCHES == before + 1
    _check(got, l2.pairwise_distance_plain(q, x, kernel), integer)


@pytest.mark.parametrize("shape", [(9, 21, 33), (256, 128, 128)])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("kernel", ["l2", "ip"])
def test_gather_kernel_matches_plain(card, shape, integer, kernel):
    from repro_torch.kernels import gather_distance as gd
    b, k, d = shape
    n = 500
    u = _data((b, d), integer, 3, card)
    data = _data((n, d), integer, 4, card)
    r = np.random.default_rng(5)
    ids = torch.from_numpy(r.integers(-1, n, (b, k)).astype(np.int32)).to(card)
    mask = torch.from_numpy(r.random((b, k)) < 0.7).to(card)
    cached = _data((b, k), False, 6, card)
    got = gd.gather_distance_ids(u, data, ids, cached, mask, kernel=kernel)
    _check(got, gd.gather_distance_ids_plain(u, data, ids, cached, mask,
                                             kernel), integer)
    keep = ~mask | (ids < 0)
    assert torch.equal(got[keep], cached[keep])
    c = data[ids.clamp_min(0).long()].contiguous()
    got = gd.gather_distance(u, c, cached, mask, kernel=kernel)
    _check(got, gd.gather_distance_plain(u, c, cached, mask, kernel),
           integer)


def _int8_case(b, k, n, d, scale_one, seed, dev):
    """Queries, an int8 corpus with its scale and dequantized norms, ids
    with INVALID lanes, a mask and a cache.  ``scale_one``: integer keys
    whose every dimension reaches 127 and integer queries, so the scale is
    1 and every ADC distance an exact integer; else gaussian data."""
    from repro_torch.core import metric
    r = np.random.default_rng(seed)
    if scale_one:
        x = r.integers(-127, 128, (n, d)).astype(np.float32)
        x[np.arange(d) % n, np.arange(d)] = 127
        u = np.round(r.normal(size=(b, d)) * 8).astype(np.float32)
    else:
        x = r.normal(size=(n, d)).astype(np.float32)
        u = r.normal(size=(b, d)).astype(np.float32)
    quant = metric.quantize_sq8(torch.from_numpy(x).to(dev))
    ids = r.integers(-1, n, (b, k)).astype(np.int32)
    return (torch.from_numpy(u).to(dev), quant,
            torch.from_numpy(ids).to(dev),
            torch.from_numpy(r.random((b, k)) < 0.7).to(dev),
            _data((b, k), False, seed + 1, dev))


@pytest.mark.parametrize("shape", [(9, 21, 33), (64, 1, 128), (64, 128, 128)])
@pytest.mark.parametrize("scale_one", [False, True])
@pytest.mark.parametrize("kernel", ["l2", "ip"])
def test_gather_sq8_kernel_matches_plain(card, shape, scale_one, kernel):
    from repro_torch.kernels import gather_distance as gd
    from repro_torch.kernels import ops, ref
    b, k, d = shape
    u, quant, ids, mask, cached = _int8_case(b, k, 300, d, scale_one, 8,
                                             card)
    if scale_one:
        assert torch.equal(quant.scale, torch.ones_like(quant.scale))
    qs, qn = ops.prescale(u, quant.scale, kernel)
    before = gd.LAUNCHES_SQ8
    got = gd.gather_distance_sq8_ids(qs, qn, quant.codes, quant.norms, ids,
                                     cached, mask, kernel=kernel)
    assert gd.LAUNCHES_SQ8 == before + 1
    _check(got, gd.gather_distance_sq8_ids_plain(
        qs, qn, quant.codes, quant.norms, ids, cached, mask, kernel),
        scale_one)
    keep = ~mask | (ids < 0)
    assert torch.equal(got[keep], cached[keep])
    safe = ids.clamp_min(0).long()
    codes, cn = quant.codes[safe].contiguous(), quant.norms[safe].contiguous()
    got = gd.gather_distance_sq8(qs, qn, codes, cn, cached, mask,
                                 kernel=kernel)
    _check(got, ref.gather_distance_adc_ref(qs, qn, codes, cn, cached, mask,
                                            kernel), scale_one)
    assert torch.equal(got[~mask], cached[~mask])


@pytest.mark.parametrize("shape", [(37, 91, 50), (200, 1000, 128)])
@pytest.mark.parametrize("scale_one", [False, True])
@pytest.mark.parametrize("kernel", ["l2", "ip"])
def test_pairwise_sq8_kernel_matches_plain(card, shape, scale_one, kernel):
    from repro_torch.kernels import l2_distance as l2
    from repro_torch.kernels import ops, ref
    nq, nx, d = shape
    u, quant, _, _, _ = _int8_case(nq, 1, nx, d, scale_one, 9, card)
    qs, qn = ops.prescale(u, quant.scale, kernel)
    before = l2.LAUNCHES_SQ8
    got = l2.pairwise_distance_sq8(qs, qn, quant.codes, quant.norms,
                                   kernel=kernel)
    assert l2.LAUNCHES_SQ8 == before + 1
    _check(got, ref.pairwise_distance_adc_ref(qs, qn, quant.codes,
                                              quant.norms, kernel), scale_one)


def test_card_build_equals_cpu_build_on_integer_data(card):
    from repro_torch.core import vamana
    data = _data((600, 16), True, 7, torch.device("cpu"))
    ps = [vamana.VamanaParams(32, 12, 1.1), vamana.VamanaParams(24, 16, 1.3)]
    gpu = vamana.build_multi_vamana(data, ps, seed=1, device="cuda")
    cpu = vamana.build_multi_vamana(data, ps, seed=1, device="cpu")
    assert torch.equal(gpu.g.ids.cpu(), cpu.g.ids)
    assert gpu.counters == cpu.counters


def test_card_serving_equals_cpu_on_integer_data(card):
    """sq8 and fp32 retrieval on the card and on the CPU: identical pools
    and counters on scale-1 integer keys."""
    from repro_torch.core import vamana
    from repro_torch.serve import retrieval
    r = np.random.default_rng(10)
    keys = r.integers(-127, 128, (500, 16)).astype(np.float32)
    keys[np.arange(16), np.arange(16)] = 127
    vals = r.normal(size=(500, 16)).astype(np.float32)
    q = r.integers(-9, 10, (40, 16)).astype(np.float32)
    p = vamana.VamanaParams(24, 12, 1.0)
    idx = {dev: retrieval.build_index(keys, vals, p, quantize="sq8",
                                      batch_size=128, device=dev)
           for dev in ("cuda", "cpu")}
    for quantize in ("none", "sq8"):
        out = {dev: retrieval.retrieval_attention_batched(
            idx[dev], q, top_k=8, ef=16, block_size=16, quantize=quantize)
            for dev in idx}
        (o_gpu, r_gpu), (o_cpu, r_cpu) = out["cuda"], out["cpu"]
        assert torch.equal(r_gpu.pool_ids.cpu(), r_cpu.pool_ids)
        assert torch.equal(r_gpu.pool_dist.cpu(), r_cpu.pool_dist)
        assert int(r_gpu.n_computed) == int(r_cpu.n_computed)
        assert r_gpu.hops == r_cpu.hops
        torch.testing.assert_close(o_gpu.cpu(), o_cpu, rtol=1e-5, atol=1e-5)
