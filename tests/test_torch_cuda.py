"""The port's CUDA ring kernels against their plain PyTorch versions on the
card: bit-equal (``torch.equal``). These tests need an NVIDIA GPU with
``nvcc`` (the kernels build at first use); where no card is visible they
skip. On the card, where JAX is not installed, skip the suite's conftest:
``pytest --noconftest tests/test_torch_cuda.py -m cuda``.

Each test loops over its cases and names the failing one in its message,
so the suite adds few items to the tier-1 collection."""
import pytest
import torch

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ring kernels run only there)")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    return g


def _make(shape, dtype, gen):
    if dtype == torch.int32:
        return torch.randint(-1000, 1000, shape, generator=gen,
                             device="cuda", dtype=torch.int32)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


DTYPES = [torch.float32, torch.int32, torch.bfloat16, torch.float16,
          torch.float64]
WIRES = [(torch.bfloat16, None), (torch.float16, None), (torch.int8, 10.0)]


def test_reduce_scatter_kernels(gen):
    """ring_rs_kernel over P in {2, 3, 8}, every dtype, SUM and MAX, at a
    ragged length; chunked_rs_kernel with each wire, both directions."""
    from accl_tpu_torch.constants import reduceFunction
    from accl_tpu_torch.parallel import pallas_chunked as pc
    from accl_tpu_torch.parallel import pallas_ring as pr
    for P in (2, 3, 8):
        for dtype in DTYPES:
            for f in (reduceFunction.SUM, reduceFunction.MAX):
                x = _make((P, P, 1000), dtype, gen)
                assert torch.equal(pr.ring_reduce_scatter(x, f),
                                   pr.plain_ring_reduce_scatter(x, f)), \
                    (P, dtype, f.name)
    f = reduceFunction.SUM
    for wire in WIRES:
        for bidir in (False, True):
            x = _make((8, 8, 5, 777), torch.float32, gen) * 4
            assert torch.equal(
                pc.chunked_reduce_scatter(x, f, wire, bidir),
                pc.plain_chunked_reduce_scatter(x, f, wire, bidir)), \
                (wire, bidir)


def test_allgather_kernels(gen):
    from accl_tpu_torch.parallel import pallas_chunked as pc
    from accl_tpu_torch.parallel import pallas_ring as pr
    for dtype in (torch.int8, torch.bfloat16, torch.float32, torch.int64):
        b = _make((8, 1234), torch.float32, gen).mul(50).to(dtype)
        assert torch.equal(pr.ring_allgather(b),
                           pr.plain_ring_allgather(b)), dtype
        for bidir in (False, True):
            b = _make((8, 4, 1234), torch.float32, gen).mul(50).to(dtype)
            assert torch.equal(pc.chunked_allgather(b, bidir),
                               pc.plain_chunked_allgather(b, bidir)), \
                (dtype, bidir)


def test_accl_allreduce_on_card(gen, monkeypatch):
    """The host API on the card against the same program on the CPU, on
    the flat, ring-kernel and segmented-kernel paths, each call completed
    by its request; then a ring timeout fails the request."""
    import accl_tpu_torch as at
    from accl_tpu_torch.parallel import pallas_ring as pr
    for nbytes in (4, 1 << 20, 4 << 20, 16 << 20):
        count = nbytes // 4
        x = _make((8, count), torch.float32, gen)
        out = {}
        for dev in ("cuda", "cpu"):
            acc = at.ACCL(world=8, device=dev, config=at.ACCLConfig(
                transport=at.TransportBackend.ICI))
            s = acc.create_buffer(count, at.dataType.float32)
            r = acc.create_buffer(count, at.dataType.float32)
            s.device_store(x.to(dev))
            req = acc.allreduce(s, r, count, at.reduceFunction.SUM,
                                from_device=True, to_device=True,
                                run_async=True)
            req.wait()
            out[dev] = r.data.cpu()
        assert torch.equal(out["cuda"], out["cpu"]), nbytes

    # with a zero spin bound every hop that has to wait times out: the
    # launches still return, and the call's request raises at wait
    monkeypatch.setattr(pr, "SPIN_TIMEOUT_S", 0.0)
    acc = at.ACCL(world=8, config=at.ACCLConfig(
        transport=at.TransportBackend.ICI))
    count = (4 << 20) // 4
    s = acc.create_buffer(count, at.dataType.float32)
    r = acc.create_buffer(count, at.dataType.float32)
    s.device_store(_make((8, count), torch.float32, gen))
    req = acc.allreduce(s, r, count, at.reduceFunction.SUM,
                        from_device=True, to_device=True, run_async=True)
    with pytest.raises(at.ACCLError) as ei:
        req.wait()
    assert ei.value.code == at.errorCode.KRNL_TIMEOUT_STS_ERROR
    assert req.status == at.requestStatus.ERROR
