"""The yardstick's arithmetic on hand-worked cases: the kernel-family
classifier, the exchange bound, the transform byte table, the interval
union of the idle share, a synthetic trace with known gaps, and every
per-layer metric's reader."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import spec, trace  # noqa: E402
from portbench.metrics import arithmetic as ar  # noqa: E402


@pytest.mark.parametrize("name,fam", [
    ("csplit_mm_tc_kernel(CUtensorMap, CUtensorMap, ...)", "K1 csplit_mm"),
    ("a2a_kernel(Args)", ar.K2),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", "NCCL"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32", "GEMM "
     "(torch.matmul)"),
    ("void regular_fft<512u, EPT<8u>, 64u, 8u, 2u>(...)", ar.FFT),
    ("void vector_fft_c2r<2048u>(...)", ar.FFT),
    ("Memcpy DtoD (Device -> Device)", ar.COPIES),
    ("void at::native::elementwise_kernel<128, 2, direct_copy_kernel_cuda>",
     ar.COPIES),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>",
     ar.COPIES),
    ("void at::native::roll_cuda_kernel<c10::complex<float> >(...)",
     ar.COPIES),
    ("memcpy128", ar.COPIES),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
     "kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>", ar.COPIES),
    # "roll" inside "unrolled": a complex multiply, not a copy
    ("void at::native::unrolled_elementwise_kernel<at::native::BinaryFunctor"
     "<c10::complex<float>, c10::complex<float>, c10::complex<float>, at::"
     "native::binary_internal::MulFunctor<c10::complex<float> > >, std::"
     "array<char*, 3ul>, 4, TrivialOffsetCalculator<2, unsigned int>>",
     ar.OTHER),
    ("void at::native::vectorized_elementwise_kernel<4, MulFunctor<float>>",
     ar.OTHER),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float, SumOps>>",
     ar.OTHER),
])
def test_family(name, fam):
    assert ar.family(name) == fam


def test_k2_bound_of_the_4096_census():
    """52 full complex64 fields a step at 4096² on 4 ranks (PERF.md §5):
    1.3086 GB cross a rank, 2.908 ms at 450 GB/s each way; HBM's read and
    write of the rank's blocks bound it at 1.0416 ms."""
    nbytes = 52 * 4096 * (4096 // 4) * 8
    assert nbytes * 3 / 4 / 1e9 == pytest.approx(1.3086, abs=5e-5)
    bound, hbm, link = ar.k2_bound_ms(nbytes, cards=4, nranks=4)
    assert link == pytest.approx(2.908, abs=5e-4)
    assert hbm == pytest.approx(2 * nbytes / 3.35e12 * 1e3)
    assert bound == link
    # four ranks on one card: nothing crosses a link, HBM bounds it
    bound1, hbm1, link1 = ar.k2_bound_ms(nbytes, cards=1, nranks=4)
    assert link1 == 0 and bound1 == hbm1 == pytest.approx(4 * hbm)


@pytest.mark.parametrize("method,per_field", [
    ("fft2", 2 * 8 * 64),             # complex in, complex out
    ("ifft2", 2 * 8 * 64),
    ("fft2_real", (4 + 8) * 64),      # real in, full complex out
    ("ifft2_real", (8 + 4) * 64),
    ("ifft2_real_pairs", (8 + 4) * 64),
    ("rfft2", 4 * 64 + 8 * 8 * 5),    # real in, half spectrum (8 x 5) out
    ("irfft2", 8 * 8 * 5 + 4 * 64),
])
def test_transform_bytes_one_card(method, per_field):
    assert ar.transform_bytes({method: 3}, nx=8, ranks=1, itemsize=8,
                              half_width=5) == 3 * per_field


def test_transform_bytes_on_a_mesh():
    """A rank moves its block: the 52-field pencil step at 4096² on 4
    ranks, complex64, and a padded half spectrum."""
    counts = {"fft2": 8, "fft2_real": 16, "ifft2": 12, "ifft2_real": 16}
    block = 4096 * 4096 / 4
    want = (20 * 16 + 32 * 12) * block
    assert ar.transform_bytes(counts, 4096, 4, 8, 2049) == want
    assert ar.transform_bytes({"rfft2": 1}, 64, 4, 8, 36) == (
        4 * 64 * 64 / 4 + 8 * 64 * 36 / 4)
    with pytest.raises(ValueError):
        ar.transform_bytes({"dct": 1}, 64, 1, 8, 33)


def test_union_and_gaps():
    iv = [(5, 7), (0, 2), (1, 3), (6, 9), (12, 13)]
    assert ar.merge(iv) == [(0, 3), (5, 9), (12, 13)]
    assert ar.union_length(iv) == 8
    assert ar.union_length(iv, 1, 12.5) == 2 + 4 + 0.5
    assert ar.gaps(iv, -1, 15) == [(-1, 0), (3, 5), (9, 12), (13, 15)]
    assert ar.gaps(iv, 1, 8) == [(3, 5)]
    assert ar.gaps([], 0, 4) == [(0, 4)]


def _synthetic():
    """A 100-µs window: an FFT 10-30, an elementwise kernel 25-50 (it
    overlaps the FFT), a copy 60-70, K2 80-95; the host waits in a
    synchronise 50-80 and launches 95-100 inside a chunk span."""
    dev = [("void regular_fft<512u>", 10.0, 30.0),
           ("vectorized_elementwise_kernel<MulFunctor>", 25.0, 50.0),
           ("Memcpy DtoD (Device -> Device)", 60.0, 70.0),
           ("a2a_kernel_fwd", 80.0, 95.0),
           ("vectorized_elementwise_kernel<late>", 120.0, 130.0)]
    host = [(trace.WINDOW, 0.0, 100.0), ("chunk", 0.0, 100.0),
            ("cudaStreamSynchronize", 50.0, 80.0),
            ("cudaGraphLaunch", 95.0, 100.0)]
    return dev, host


def test_summarize_synthetic_trace():
    dev, host = _synthetic()
    s = trace.summarize(dev, host, steps=2)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((40 + 10 + 15) * 1e-6)
    fam = s["families_s"]
    assert fam[ar.FFT] == pytest.approx(20e-6)
    assert fam[ar.OTHER] == pytest.approx(25e-6)   # the late one is outside
    assert fam[ar.COPIES] == pytest.approx(10e-6)
    assert fam[ar.K2] == pytest.approx(15e-6)
    idle = dict(s["idle_gaps"])
    # 0-10 and 95-100 under the chunk span alone; 50-60 and 70-80 in the
    # synchronise
    assert idle == pytest.approx({"chunk": 10e-6,
                                  "cudaStreamSynchronize": 20e-6,
                                  "cudaGraphLaunch": 5e-6})
    assert s["idle_gaps"][0][0] == "cudaStreamSynchronize"
    assert s["device_ops"][0][0].startswith(ar.OTHER)


def _reading(**kw):
    r = {"steps": 2, "window_s": 100e-6, "busy_s": 65e-6,
         "families_s": {ar.FFT: 20e-6, ar.OTHER: 25e-6, ar.COPIES: 10e-6,
                        ar.K2: 15e-6},
         "census": {"counts": {"fft2": 1}, "nx": 64, "ranks": 4, "cards": 4,
                    "itemsize": 8, "half_width": 36, "k2_bytes": 4e5}}
    r.update(kw)
    return r


def test_readers():
    r = _reading()
    read = lambda name, rr=r: spec.reader(name)(rr)  # noqa: E731
    assert read("device.idle_pct") == pytest.approx(35.0)
    assert read("device.copy_ms") == pytest.approx(5e-3)
    assert read("step.elementwise_ms") == pytest.approx(12.5e-3)
    nbytes = 2 * 8 * 64 * 64 / 4
    assert read("fft.roofline_pct") == pytest.approx(
        100 * nbytes / ar.PEAK_BYTES / 10e-6)
    bound = ar.k2_bound_ms(4e5, 4, 4)[0]
    assert read("k2.roofline_pct") == pytest.approx(100 * bound / 7.5e-3)


def test_readers_without_their_layer_return_nothing():
    """A cell without K2, an FFT or a census reads nothing (never 0)."""
    bare = _reading(families_s={ar.OTHER: 25e-6}, census=None)
    for name in ("k2.roofline_pct", "fft.roofline_pct", "device.copy_ms"):
        assert spec.reader(name)(bare) is None, name
    no_k2 = _reading(census=dict(_reading()["census"], k2_bytes=0))
    assert spec.reader("k2.roofline_pct")(no_k2) is None
