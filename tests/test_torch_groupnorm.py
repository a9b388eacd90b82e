"""The port's fused GroupNorm + GELU op and the conv probe's functions
against ``apv_tpu``.

``groupnorm_gelu`` on CPU tensors is the plain version (a copy of the
reference's ``_reference``), differentiated by autograd; its gradients are
held to ``jax.vjp`` of the reference's ``custom_vjp``, whose backward is
the hand-derived ``_bwd``. The CUDA path's ``autograd.Function`` is
rehearsed with the plain versions standing in for the two kernels, and
the wrappers' counting of the kernel each launch ran with a fake library
standing in for the build. The conv probe's plain contenders are held to
``lax.conv_general_dilated``.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apv_tpu.ops import groupnorm as jgn
from apv_tpu_torch.ops import _build, conv_probe
from apv_tpu_torch.ops import groupnorm as tgn
from apv_tpu_torch.ops import kernels as K
from apv_tpu_torch.ops.groupnorm import groupnorm_gelu

torch.set_num_threads(1)

# (shape, groups): the reference test's cases and an odd one (3 channels a
# group, 35 pixels)
CASES = [((4, 8, 8, 32), 8), ((2, 16, 16, 64), 8), ((3, 4, 4, 16), 4),
         ((3, 7, 5, 24), 8)]


def _inputs(rng, shape):
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.3).astype(np.float32)
    gamma = (rng.normal(size=c) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.normal(size=c) * 0.1).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, gamma, beta, dy


def _t(a):
    return torch.from_numpy(np.array(a))


def _scale_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_ulps(got, want):
    """max |got - want| / (one bf16 ulp of want + 1e-5): both sides round
    f32 values once, and those agree to the f32 bar of 1e-5; near zero the
    bf16 grid is finer than that bar, hence the 1e-5 beside the ulp."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    return float((np.abs(got - want) / (ulp + 1e-5)).max())


@pytest.mark.parametrize("shape,groups", CASES)
def test_value_parity_f32(rng, shape, groups):
    """f32 values against the op and ``_reference``: 1e-5 abs + rel."""
    x, g, b, _ = _inputs(rng, shape)
    got = groupnorm_gelu(_t(x), _t(g), _t(b), groups).numpy()
    want = np.asarray(jgn.groupnorm_gelu(x, g, b, groups))
    ref = np.asarray(jgn._reference(x, g, b, groups, 1e-6))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,groups", CASES[:1] + CASES[-1:])
def test_value_parity_bf16(rng, shape, groups):
    """bf16 in and out: within one bf16 ulp of the reference's (both
    compute in f32 and round once), plus the f32 bar near zero."""
    x, g, b, _ = _inputs(rng, shape)
    x16 = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jgn.groupnorm_gelu(x16, g, b, groups), np.float32)
    xt = _t(np.asarray(x16, np.float32)).to(torch.bfloat16)
    got = groupnorm_gelu(xt, _t(g), _t(b), groups)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got.float().numpy(), want) <= 1.0


def test_rejects_bad_groups(rng):
    x = _t(rng.normal(size=(2, 4, 4, 30)).astype(np.float32))
    with pytest.raises(ValueError, match="divisible"):
        groupnorm_gelu(x, torch.ones(30), torch.zeros(30), 8)
    with pytest.raises(ValueError, match="divisible"):
        K.groupnorm_gelu_plain(x, torch.ones(30), torch.zeros(30), 8)


@pytest.mark.parametrize("shape,groups", CASES[:1] + CASES[-1:])
def test_grad_parity_vs_jax_vjp(rng, shape, groups):
    """Autograd of the plain version against jax.vjp of the custom_vjp
    (its ``_bwd``): scale-relative 1e-4 for dx, dgamma, dbeta."""
    x, g, b, dy = _inputs(rng, shape)
    _, vjp = jax.vjp(lambda *a: jgn.groupnorm_gelu(*a, groups), x, g, b)
    want = vjp(jnp.asarray(dy))
    xt, gt, bt = (_t(a).requires_grad_(True) for a in (x, g, b))
    got = torch.autograd.grad(groupnorm_gelu(xt, gt, bt, groups),
                              (xt, gt, bt), _t(dy))
    for a, w, name in zip(got, want, ("dx", "dgamma", "dbeta")):
        assert _scale_rel(a.numpy(), w) <= 1e-4, name


@pytest.mark.parametrize("shape,groups", CASES[:1] + CASES[-1:])
def test_bwd_plain_is_the_reference_rule(rng, shape, groups):
    """``groupnorm_gelu_bwd_plain`` against ``_bwd`` on ``_fwd``'s
    residuals, and the plain forward's statistics against ``_fwd``'s."""
    x, g, b, dy = _inputs(rng, shape)
    _, (_, _, _, mean, rstd) = jgn._fwd(x, g, b, groups, 1e-6)
    want = jgn._bwd(groups, 1e-6, (x, g, b, mean, rstd), jnp.asarray(dy))
    _, m, r = K.groupnorm_gelu_plain(_t(x), _t(g), _t(b), groups)
    np.testing.assert_allclose(m.numpy(), np.asarray(mean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(rstd), rtol=1e-5)
    got = K.groupnorm_gelu_bwd_plain(_t(dy), _t(x), _t(g), _t(b),
                                     _t(np.asarray(mean)),
                                     _t(np.asarray(rstd)), groups)
    for a, w in zip(got, want):
        assert _scale_rel(a.numpy(), w) <= 1e-5


@pytest.fixture
def gn_on_cuda_path(monkeypatch):
    """Send CPU tensors down the CUDA path, the two kernels replaced by
    their plain versions with a launch count."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(x, g, b, groups=8, eps=1e-6):
        assert x.is_contiguous() and g.dtype == b.dtype == torch.float32
        assert not (x.requires_grad or g.requires_grad or b.requires_grad)
        calls["fwd"] += 1
        return K.groupnorm_gelu_plain(x, g, b, groups, eps)

    def bwd(dy, x, g, b, mean, rstd, groups=8):
        assert dy.dtype == x.dtype and dy.is_contiguous()
        calls["bwd"] += 1
        return K.groupnorm_gelu_bwd_plain(dy, x, g, b, mean, rstd, groups)

    monkeypatch.setattr(tgn, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(K, "groupnorm_gelu_cuda", fwd)
    monkeypatch.setattr(K, "groupnorm_gelu_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_rehearsed(rng, gn_on_cuda_path, dtype):
    """The CUDA path's autograd.Function with plain stand-ins: one forward
    and one backward launch, the same values and gradients as autograd of
    the plain version (scale-relative 1e-5 in f32, 1e-2 in bf16), and
    gradients in the parameters' dtype."""
    x, g, b, dy = _inputs(rng, (3, 7, 5, 24))
    xt = _t(x).to(dtype).requires_grad_(True)
    gt, bt = _t(g).requires_grad_(True), _t(b).requires_grad_(True)
    dyt = _t(dy).to(dtype)
    y = groupnorm_gelu(xt, gt, bt, 8)
    got = torch.autograd.grad(y, (xt, gt, bt), dyt)
    assert gn_on_cuda_path == {"fwd": 1, "bwd": 1}
    xp, gp, bp = (t.detach().clone().requires_grad_(True)
                  for t in (xt, gt, bt))
    yp = K.groupnorm_gelu_plain(xp, gp, bp, 8)[0]
    want = torch.autograd.grad(yp, (xp, gp, bp), dyt)
    assert torch.equal(y.detach(), yp.detach())
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        assert _scale_rel(a.float().numpy(), w.float().numpy()) <= tol


class _FakeLibrary:
    """The kernel library's two groupnorm entry points on the CPU: each
    reports ``route`` through its ``int*`` out-parameter (the argument
    before the stream) and returns 0, writing no output."""

    def __init__(self, route):
        self.route, self.calls = route, []

    def _entry(self, name):
        def call(*args):
            assert len(args) == len(_build.SIGNATURES[name])
            args[-2]._obj.value = self.route
            self.calls.append(name)
            return 0
        return call

    def __getattr__(self, name):
        return self._entry(name)


@pytest.mark.parametrize("route,name", [(0, "image"), (1, "rows")])
def test_groupnorm_route_counting_rehearsed(monkeypatch, route, name):
    """``groupnorm_gelu_cuda`` and ``groupnorm_gelu_bwd_cuda`` count each
    launch under the kernel the C entry point reports (0 image, 1 rows),
    with a fake library standing in for the build and CPU tensors for CUDA
    ones; ``reset_launches`` clears both counters."""
    fake = _FakeLibrary(route)
    monkeypatch.setattr(K, "_lib", lambda: fake)
    monkeypatch.setattr(K, "_check_gn", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    K.reset_launches()
    x = torch.zeros(2, 4, 4, 16)
    g, b = torch.ones(16), torch.zeros(16)
    _, mean, rstd = K.groupnorm_gelu_cuda(x, g, b, 4)
    K.groupnorm_gelu_cuda(x, g, b, 4)
    K.groupnorm_gelu_bwd_cuda(x, x, g, b, mean, rstd, 4)
    assert fake.calls == ["apv_groupnorm_gelu"] * 2 \
        + ["apv_groupnorm_gelu_bwd"]
    assert K.groupnorm_gelu_routes == {**dict.fromkeys(K.GN_KERNELS, 0),
                                       name: 2}
    assert K.groupnorm_gelu_bwd_routes == {
        **dict.fromkeys(K.GN_KERNELS, 0), name: 1}
    assert (K.launches["groupnorm_gelu"],
            K.launches["groupnorm_gelu_bwd"]) == (2, 1)
    K.reset_launches()
    assert set(K.groupnorm_gelu_routes.values()) == {0}
    assert set(K.groupnorm_gelu_bwd_routes.values()) == {0}
    assert set(K.launches.values()) == {0}


def test_channels_last_view_is_the_nhwc_input(rng):
    """A channels_last NCHW activation's permute(0, 2, 3, 1) is a
    contiguous NHWC view of the same memory."""
    a = torch.randn(2, 16, 5, 7).contiguous(memory_format=torch.channels_last)
    v = a.permute(0, 2, 3, 1)
    assert v.is_contiguous() and v.data_ptr() == a.data_ptr()
    y = groupnorm_gelu(v, torch.ones(16), torch.zeros(16), 4)
    assert y.shape == (2, 5, 7, 16)


def test_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 2, 2, 8)
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.groupnorm_gelu_cuda(x, torch.ones(8), torch.zeros(8), 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.conv3x3_cuda(x, torch.zeros(3, 3, 8, 4))
    with pytest.raises(TypeError):
        K.conv3x3_cuda(x, torch.zeros(3, 3, 8, 4, dtype=torch.bfloat16))


def _lax_conv(x, w):
    return np.asarray(jax.lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST), np.float32)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 16), (3, 5, 7, 8, 12)])
def test_conv_plain_contenders_vs_lax_conv(rng, shape):
    """``nine_dot`` and ``conv3x3_plain`` against lax.conv (f32: 1e-5
    relative to max |ref|); ``conv3x3_plain`` on bf16 inputs is the f32
    conv of the bf16-rounded inputs, out in f32."""
    b, h, w, cin, cout = shape
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
    ref = _lax_conv(x, wt)
    for got in (conv_probe.nine_dot(_t(x), _t(wt)),
                K.conv3x3_plain(_t(x), _t(wt)),
                conv_probe.conv3x3(_t(x), _t(wt)),
                conv_probe.torch_conv(_t(x), _t(wt))):
        assert got.dtype == torch.float32
        assert _scale_rel(got.numpy(), ref) <= 1e-5
    x16, w16 = (_t(a).to(torch.bfloat16) for a in (x, wt))
    ref16 = _lax_conv(x16.float().numpy(), w16.float().numpy())
    got16 = K.conv3x3_plain(x16, w16)
    assert got16.dtype == torch.float32
    assert _scale_rel(got16.numpy(), ref16) <= 1e-5
    assert conv_probe.nine_dot(x16, w16).dtype == torch.bfloat16


def test_conv3x3_dispatch_rehearsed(rng, monkeypatch):
    """On the CUDA path ``conv3x3`` hands contiguous tensors to the kernel
    wrapper (the plain version standing in)."""
    seen = []

    def stand_in(x, w):
        assert x.is_contiguous() and w.is_contiguous()
        seen.append(tuple(x.shape))
        return K.conv3x3_plain(x, w)

    monkeypatch.setattr(conv_probe, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(K, "conv3x3_cuda", stand_in)
    x = _t(rng.normal(size=(2, 6, 6, 8)).astype(np.float32))
    w = _t(rng.normal(size=(3, 3, 8, 8)).astype(np.float32))
    out = conv_probe.conv3x3(x.permute(0, 2, 1, 3), w)
    assert seen == [(2, 6, 6, 8)] and out.shape == (2, 6, 6, 8)


def test_conv_probe_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe runs")
    with pytest.raises(RuntimeError, match="none is available"):
        conv_probe.run()
