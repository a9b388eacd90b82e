"""The port's fused RMSNorm + activation op (``ops.rmsnorm_act``), on the
CPU.

On CPU tensors the op is the ResNet's eager chain (``K.rmsnorm_act_plain``),
held here bit for bit to the chain the ResNet ran before the op existed,
and to flax's ``nn.RMSNorm`` followed by the activation through
``jax.vjp``. The hand-derived backward (``K.rmsnorm_act_bwd_plain``, the
function of the backward kernel) is held to autograd of the plain
forward. The CUDA path's ``autograd.Function`` is rehearsed with the
plain versions standing in for the two kernels, and the wrappers' counting
of the kernel each launch ran with a fake library standing in for the
build. The kernels themselves are held to the plain versions on the card
(``tests/test_torch_rmsnorm_card.py``).
"""

import contextlib
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apv_tpu.models.common import get_activation as flax_act
from apv_tpu.models.resnet_vae import ResNetVAE as FlaxVAE
from apv_tpu_torch.convert import params_from_flax
from apv_tpu_torch.models import ResNetVAE
from apv_tpu_torch.models.common import RMSNormAct
from apv_tpu_torch.ops import _build
from apv_tpu_torch.ops import kernels as K
from apv_tpu_torch.ops import rmsnorm as rms
from apv_tpu_torch.ops.rmsnorm import rmsnorm_act

torch.set_num_threads(1)

ACTS = ("silu", "gelu", "gelu_sigmoid", "relu", "leaky_relu")
DTYPES = (torch.float32, torch.bfloat16)
WIDTHS = (8, 64, 128, 256)


def _inputs(rng, shape):
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.3).astype(np.float32)
    w = (rng.normal(size=c) * 0.5 + 1.0).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, w, dy


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _scale_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _eager_chain(x_nchw, w, activation):
    """The ResNet's chain before the op: RMSNorm over dim 1 of a
    channels_last NCHW tensor, rounded to its dtype, then the activation."""
    x32 = x_nchw.to(torch.float32)
    ms = x32.square().mean(dim=1, keepdim=True)
    y = x32 * (torch.rsqrt(ms + 1e-6) * w.view(1, -1, 1, 1))
    return K.ACTIVATIONS[activation](y.to(x_nchw.dtype))


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ACTS)
def test_plain_path_is_the_eager_chain(rng, activation, dtype, c):
    """The op's CPU path on the NHWC view of a channels_last activation
    equals the eager chain bit for bit, in values and in autograd's
    gradients, and its result permutes back to a channels_last tensor."""
    x, w, dy = _inputs(rng, (3, 5, 7, c))
    xn = _t(x, dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    wt = _t(w).requires_grad_(True)
    dyn = _t(dy, dtype).permute(0, 3, 1, 2)
    xa = xn.clone().requires_grad_(True)
    got = rmsnorm_act(xa.permute(0, 2, 3, 1), wt, activation)
    assert got.dtype == dtype and got.is_contiguous()
    got = got.permute(0, 3, 1, 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    ga = torch.autograd.grad(got, (xa, wt), dyn)
    xb = xn.clone().requires_grad_(True)
    want = _eager_chain(xb, wt, activation)
    gb = torch.autograd.grad(want, (xb, wt), dyn)
    assert torch.equal(got, want)
    assert torch.equal(ga[0], gb[0]) and torch.equal(ga[1], gb[1])


def _flax_rmsnorm_act(activation, dtype):
    norm = nn.RMSNorm(epsilon=1e-6, dtype=dtype)
    act = flax_act(activation)

    def fn(x, scale):
        return act(norm.apply({"params": {"scale": scale}}, x))
    return fn


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ACTS)
def test_matches_flax_rmsnorm_and_activation(rng, activation, dtype):
    """Values and ``jax.vjp`` gradients of flax's ``nn.RMSNorm`` followed
    by the activation against the op's, scale-relative: 1e-3 in f32; in
    bf16 2⁻⁷ for values (JAX computes the activation op by op in bf16,
    PyTorch in f32 from the bf16 input: a rounding or two apart) and 2⁻⁵
    for gradients (JAX's backward rounds each of its ~8 bf16 products and
    casts; PyTorch rounds the activation's gradient once)."""
    x, w, dy = _inputs(rng, (2, 4, 4, 64))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x, jdt)
    want, vjp = jax.vjp(_flax_rmsnorm_act(activation, jdt), xj,
                        jnp.asarray(w))
    wdx, wdw = vjp(jnp.asarray(dy, jdt))
    xt = _t(np.asarray(xj, np.float32), dtype).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    got = rmsnorm_act(xt, wt, activation)
    gdx, gdw = torch.autograd.grad(got, (xt, wt), _t(dy, dtype))
    bar, grad_bar = ((1e-3, 1e-3) if dtype == torch.float32
                     else (2.0 ** -7, 2.0 ** -5))
    assert _scale_rel(got.float().detach(), np.asarray(want, np.float32)) \
        <= bar
    assert _scale_rel(gdx.float(), np.asarray(wdx, np.float32)) <= grad_bar
    assert _scale_rel(gdw, np.asarray(wdw, np.float32)) <= grad_bar


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ACTS)
def test_bwd_plain_is_autograd_of_the_plain(rng, activation, dtype):
    """``rmsnorm_act_bwd_plain`` on the forward's rstd against autograd of
    ``rmsnorm_act_plain``: scale-relative 1e-5 in f32; 1e-2 in bf16, where
    autograd rounds the activation's gradient to bf16 and the rule keeps
    it in f32. The rstd is the forward's own."""
    x, w, dy = _inputs(rng, (3, 7, 5, 24))
    xt = _t(x, dtype).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    want = torch.autograd.grad(K.rmsnorm_act_plain(xt, wt, activation),
                               (xt, wt), _t(dy, dtype))
    rstd = K.rms_rstd(xt.detach())
    x32 = xt.detach().float()
    assert torch.equal(rstd, torch.rsqrt(
        x32.square().mean(dim=-1, keepdim=True) + 1e-6)[..., 0])
    got = K.rmsnorm_act_bwd_plain(_t(dy, dtype), xt.detach(), wt.detach(),
                                  rstd, activation)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, want):
        assert _scale_rel(a.float(), b.float()) <= tol


@pytest.fixture
def rms_on_cuda_path(monkeypatch):
    """Send CPU tensors down the CUDA path, the two kernels replaced by
    their plain versions with a launch count."""
    calls = {"fwd": 0, "bwd": 0, "rstd": 0}

    def fwd(x, w, activation, eps=1e-6, want_rstd=False):
        assert x.is_contiguous() and w.dtype == torch.float32
        assert not (x.requires_grad or w.requires_grad)
        calls["fwd"] += 1
        calls["rstd"] += int(want_rstd)
        y = K.rmsnorm_act_plain(x, w, activation, eps)
        return y, (K.rms_rstd(x, eps) if want_rstd else None)

    def bwd(dy, x, w, rstd, activation):
        assert dy.dtype == x.dtype and dy.is_contiguous()
        calls["bwd"] += 1
        return K.rmsnorm_act_bwd_plain(dy, x, w, rstd, activation)

    monkeypatch.setattr(rms, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(K, "rmsnorm_act_cuda", fwd)
    monkeypatch.setattr(K, "rmsnorm_act_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_function_rehearsed(rng, rms_on_cuda_path, dtype):
    """The CUDA path's autograd.Function with plain stand-ins: one forward
    launch (with the rstd) and one backward launch, the same values, the
    gradients of autograd of the plain version (scale-relative 1e-5 in
    f32, 1e-2 in bf16), and dw in the parameter's dtype."""
    x, w, dy = _inputs(rng, (3, 7, 5, 24))
    xt = _t(x, dtype).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    dyt = _t(dy, dtype)
    y = rmsnorm_act(xt, wt, "silu")
    got = torch.autograd.grad(y, (xt, wt), dyt)
    assert rms_on_cuda_path == {"fwd": 1, "bwd": 1, "rstd": 1}
    xp, wp = (t.detach().clone().requires_grad_(True) for t in (xt, wt))
    yp = K.rmsnorm_act_plain(xp, wp, "silu")
    want = torch.autograd.grad(yp, (xp, wp), dyt)
    assert torch.equal(y.detach(), yp.detach())
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert _scale_rel(a.float(), b.float()) <= tol


def test_inference_writes_no_rstd(rng, rms_on_cuda_path):
    """Without a gradient to take (no_grad, or inputs that need none) the
    op launches the forward kernel alone and asks for no rstd."""
    x, w, _ = _inputs(rng, (2, 3, 3, 16))
    xt, wt = _t(x), _t(w).requires_grad_(True)
    with torch.no_grad():
        y = rmsnorm_act(xt, wt, "gelu")
    rmsnorm_act(xt, wt.detach(), "gelu")
    assert rms_on_cuda_path == {"fwd": 2, "bwd": 0, "rstd": 0}
    assert torch.equal(y, K.rmsnorm_act_plain(xt, wt.detach(), "gelu"))


class _FakeLibrary:
    """The kernel library's two rmsnorm_act entry points on the CPU: each
    reports ``route`` through its ``int*`` out-parameter (the argument
    before the stream) and returns 0, writing no output."""

    def __init__(self, route):
        self.route, self.calls = route, []

    def __getattr__(self, name):
        def call(*args):
            assert len(args) == len(_build.SIGNATURES[name])
            args[-2]._obj.value = self.route
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("route,name", [(0, "vector"), (1, "scalar")])
def test_rms_route_counting_rehearsed(monkeypatch, route, name):
    """``rmsnorm_act_cuda`` and ``rmsnorm_act_bwd_cuda`` count each launch
    under the kernel the C entry point reports (0 vector, 1 scalar), with a
    fake library standing in for the build and CPU tensors for CUDA ones;
    the forward passes a null rstd unless asked, the activation's index and
    the partials' capacity; ``reset_launches`` clears both counters."""
    fake = _FakeLibrary(route)
    monkeypatch.setattr(K, "_lib", lambda: fake)
    monkeypatch.setattr(K, "_check_gn", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    K.reset_launches()
    x = torch.zeros(2, 4, 4, 16, dtype=torch.bfloat16)
    w = torch.ones(16)
    y, rstd = K.rmsnorm_act_cuda(x, w, "gelu_sigmoid")
    assert rstd is None and y.shape == x.shape and y.dtype == x.dtype
    _, rstd = K.rmsnorm_act_cuda(x, w, "leaky_relu", want_rstd=True)
    assert rstd.shape == (2, 4, 4) and rstd.dtype == torch.float32
    dx, dw = K.rmsnorm_act_bwd_cuda(x, x, w, rstd, "silu")
    assert dx.shape == x.shape and dw.shape == (16,)
    names = [c[0] for c in fake.calls]
    assert names == ["apv_rmsnorm_act"] * 2 + ["apv_rmsnorm_act_bwd"]
    first, second, back = (c[1] for c in fake.calls)
    assert first[3] is None and second[3] is not None
    assert (first[4], first[5]) == (32, 16)
    assert first[7] == K.RMS_ACTIVATIONS.index("gelu_sigmoid") == 2
    assert second[7] == 4 and back[10] == 0 and first[8] == 1
    assert back[6] == K.RMS_PARTIAL_ROWS
    assert K.rmsnorm_act_routes == {**dict.fromkeys(K.RMS_KERNELS, 0),
                                    name: 2}
    assert K.rmsnorm_act_bwd_routes == {**dict.fromkeys(K.RMS_KERNELS, 0),
                                        name: 1}
    assert (K.launches["rmsnorm_act"], K.launches["rmsnorm_act_bwd"]) \
        == (2, 1)
    K.reset_launches()
    assert set(K.rmsnorm_act_routes.values()) == {0}
    assert set(K.rmsnorm_act_bwd_routes.values()) == {0}
    assert set(K.launches.values()) == {0}


def test_refusals():
    """Mixed devices and unknown activations raise; the wrappers refuse
    CPU tensors (no fallback to the plain chain)."""
    x, w = torch.zeros(2, 3, 8), torch.ones(8)
    with pytest.raises(ValueError, match="all be on the CPU or all on one"):
        rmsnorm_act(x, w.to("meta"), "silu")
    with pytest.raises(ValueError, match="unknown activation"):
        rmsnorm_act(x, w, "swish")
    with pytest.raises(ValueError, match="unknown activation"):
        RMSNormAct(8, activation="swish")
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.rmsnorm_act_cuda(x, w, "silu")
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.rmsnorm_act_bwd_cuda(x, x, w, torch.ones(2, 3), "silu")


def test_resnet_keeps_its_parameter_names_and_loads_flax():
    """A ``norm=rms`` ResNet keeps ``…norm1.weight``, ``…norm2.weight``,
    ``encoder.norm.weight`` and ``decoder.norm.weight`` and no other norm
    state; ``convert.params_from_flax`` loads a flax tree into it (strict)
    and the two then agree."""
    kw = dict(z_dim=8, widths=(8, 16), blocks_per_stage=1,
              image_shape=(32, 32, 3), activation="silu", norm="rms")
    model = ResNetVAE(dtype=torch.float32, **kw)
    keys = [k for k in model.state_dict() if "norm" in k]
    assert keys == [
        "encoder.stages.0.blocks.0.norm1.weight",
        "encoder.stages.0.blocks.0.norm2.weight",
        "encoder.stages.1.blocks.0.norm1.weight",
        "encoder.stages.1.blocks.0.norm2.weight", "encoder.norm.weight",
        "decoder.stages.0.blocks.0.norm1.weight",
        "decoder.stages.0.blocks.0.norm2.weight",
        "decoder.stages.1.blocks.0.norm1.weight",
        "decoder.stages.1.blocks.0.norm2.weight", "decoder.norm.weight"]
    assert sum(isinstance(m, RMSNormAct) for m in model.modules()) == 10
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    z = rng.normal(size=(2, 8)).astype(np.float32)
    fmodel = FlaxVAE(dtype=jnp.float32, **kw)
    params = fmodel.init(jax.random.PRNGKey(0), x, z)["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: p + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), p.shape)
        if str(path[-1]) == "['scale']" else p, params)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        params)),
                          strict=True)
    want = fmodel.apply({"params": params}, z, method="decode")
    with torch.no_grad():
        got = model.decode(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
