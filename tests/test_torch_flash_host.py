"""The flash-attention wrapper's host-side choices, on CPU tensors.

Which CUDA source takes which input type, which tensors the kernels can
copy in 16-byte pieces as they lie (TMA's tensor maps for bfloat16,
``cp.async`` for float32) and which are copied once first.  The kernels
themselves run only on the card (``test_torch_cuda.py``); these checks
need none.
"""
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

CSRC = Path(fa.__file__).resolve().parent / "csrc"


@pytest.mark.parametrize("dtype,source", [
    (torch.float32, "flash_attention_f32.cu"),
    (torch.bfloat16, "flash_attention_bf16.cu"),
])
def test_route_picks_the_source_by_dtype(dtype, source):
    assert fa.route(dtype) == source
    assert (CSRC / source).is_file()


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.route(dtype)


def _bshd(b, s, h, d, dtype, pad=0):
    """A (B, H, S, D) view of a (B, S, H, D + pad) tensor, as the model
    hands q, k and v in (pad 0), or with padded rows."""
    x = torch.arange(b * s * h * (d + pad), dtype=torch.float32)
    x = x.reshape(b, s, h, d + pad).to(dtype)
    return x[..., :d].transpose(1, 2)


def _misaligned(dtype, d):
    """Contiguous, but based one element past an aligned allocation."""
    flat = torch.zeros(2 * 3 * 40 * d + 1, dtype=dtype)
    return flat[1:].view(2, 3, 40, d)


@pytest.mark.parametrize("make,ready", [
    (lambda: torch.zeros(2, 4, 80, 16), True),
    (lambda: torch.zeros(2, 4, 80, 16, dtype=torch.bfloat16), True),
    (lambda: torch.zeros(1, 2, 130, 128, dtype=torch.bfloat16), True),
    (lambda: _bshd(2, 80, 3, 16, torch.bfloat16), True),
    (lambda: _bshd(2, 80, 3, 64, torch.float32), True),
    (lambda: _bshd(1, 80, 1, 16, torch.bfloat16, pad=2), False),
    (lambda: _bshd(1, 80, 1, 16, torch.float32, pad=2), False),
    (lambda: _bshd(1, 80, 2, 32, torch.bfloat16, pad=8), True),
    (lambda: _misaligned(torch.bfloat16, 32), False),
    (lambda: _misaligned(torch.float32, 16), False),
    (lambda: torch.zeros(2, 80, 3, 32).permute(0, 2, 1, 3)[..., ::2].transpose(
        2, 3), False),
    (lambda: torch.zeros(1, 1, 80, 64).expand(2, 4, 80, 64), False),
], ids=["f32-contig", "bf16-contig", "bf16-D128", "bf16-view", "f32-view",
        "bf16-row-36B", "f32-row-72B", "bf16-row-80B", "bf16-misaligned",
        "f32-misaligned", "strided-last-dim", "expanded"])
def test_tma_ready(make, ready):
    assert fa.tma_ready(make()) is ready


@pytest.mark.parametrize("make", [
    lambda: _bshd(1, 80, 1, 16, torch.bfloat16, pad=2),
    lambda: _misaligned(torch.bfloat16, 32),
    lambda: _misaligned(torch.float32, 16),
    lambda: torch.zeros(1, 1, 80, 64).expand(2, 4, 80, 64),
], ids=["odd-row-stride", "misaligned-bf16", "misaligned-f32", "expanded"])
def test_prepare_copies_what_the_kernels_cannot_read(make):
    t = make()
    got = fa.prepare(t)
    assert got is not t and fa.tma_ready(got)
    assert got.dtype == t.dtype and got.shape == t.shape
    assert torch.equal(got, t)


def test_prepare_keeps_ready_views_uncopied():
    t = _bshd(2, 80, 3, 16, torch.bfloat16)
    assert fa.prepare(t) is t


def test_cpu_tensors_with_odd_strides_take_the_plain_version():
    fa.reset_launches()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 80, 1, 18, generator=g)[..., :16].transpose(1, 2)
    out = fa.flash_attention_cuda(x, x, x, swa_window=48)
    assert fa.LAUNCHES["flash_attention"] == 0
    torch.testing.assert_close(
        out, ref.flash_attention_ref(x, x, x, swa_window=48))


def test_sources_keep_each_route_on_its_units():
    bf16 = (CSRC / fa.route(torch.bfloat16)).read_text()
    f32 = (CSRC / fa.route(torch.float32)).read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor",
                   "mbarrier.try_wait", "setmaxnreg"):
        assert needle in bf16
    assert "cp.async.cg.shared.global" in f32
    for needle in (".tf32", "wgmma.", "mma.sync"):   # PTX of tensor cores
        assert needle not in f32


def test_prefill_timing_runs_at_smoke_size_on_cpu():
    from repro_torch.configs import smoke_config
    from repro_torch.launch import prefill_timing
    cfg = smoke_config(prefill_timing.ARCH, attn_impl_train="pallas")
    walls = prefill_timing.prefill_walls(cfg, 2, 16, 2, torch.device("cpu"))
    assert len(walls) == 2 and all(w > 0 for w in walls)


@pytest.mark.parametrize("argv,arch", [([], "olmo-1b"),
                                       (["--arch", "mamba2-1.3b"],
                                        "mamba2-1.3b")])
def test_prefill_timing_takes_an_arch(argv, arch):
    from repro_torch.launch import prefill_timing
    assert prefill_timing.parse_args(argv).arch == arch


def test_prefill_timing_runs_mamba_at_smoke_size_on_cpu():
    from repro_torch.configs import smoke_config
    from repro_torch.launch import prefill_timing
    cfg = smoke_config("mamba2-1.3b")
    walls = prefill_timing.prefill_walls(cfg, 2, 16, 2, torch.device("cpu"))
    assert len(walls) == 2 and all(w > 0 for w in walls)


def test_both_routes_include_the_shared_host_header():
    for source in fa.SOURCES.values():
        assert '#include "flash_attention_host.cuh"' in (CSRC / source
                                                        ).read_text()
    assert (CSRC / "flash_attention_host.cuh").is_file()


def test_build_target_changes_with_a_header(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("k.cu")
    (tmp_path / "h.cuh").write_text("// two\n")
    after = _build._target("k.cu")
    assert before != after and before.name == after.name == "libk.so"
