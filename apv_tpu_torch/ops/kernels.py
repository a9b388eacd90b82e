"""Hand-written CUDA kernels, their ctypes wrappers, launch counters and
plain PyTorch versions.

Each forward kernel replaces one Pallas TPU kernel of
``apv_tpu/ops/kernels.py`` and computes the same function (not the same
blocks); each backward kernel replaces the jnp rule of that op's
``custom_vjp``:

* ``bernoulli`` (``csrc/bernoulli.cu``) replaces ``_bernoulli_fwd`` /
  ``_bernoulli_kernel``. Bound: memory, the logits read once and x once per
  image (10.2 MB at the MNIST IWAE chunk [3200, 784] with x [64, 784]).
  Design: a block a row, a thread per float4, one block reduction.
  ``bernoulli_bwd`` (same file) replaces ``_bernoulli_bwd``: elementwise,
  a thread per float4 and ``blockIdx.y`` the row (the grid fills the card
  at the train step's [256, 784]), dx written only when asked for.
* ``disc_logistic`` (``csrc/disc_logistic.cu``) replaces
  ``_disc_logistic_fwd`` / ``_disc_logistic_kernel``. Bound: memory, mean
  and log_scale read once and x once per image (79.4 MB at the OOD chunk
  [3200, 3072] with x [64, 3072]). Design: a block a row, one accurate
  exp, two approximate exps, one expm1 and one approximate log an element,
  float4 loads, a block reduction, [rows] written.
  ``disc_logistic_bwd`` (same file) replaces
  ``_disc_logistic_bwd``: elementwise in a block a row, bound by memory
  (15.7 MB at the train step's [256, 3072] without dx), dx written only
  when asked for.
* The two likelihood forwards take x with B rows beside parameters with
  R = S·B rows: parameter row r reads x row r % B, the order of
  ``x.expand(S, B, ...).reshape(S·B, ...)``, so the IWAE and OOD paths
  score each image under S samples without copying it S times.
* ``kl`` (``csrc/kl.cu``) replaces ``_kl_fwd`` / ``_kl_kernel``. Bound:
  launch latency (65.5 KB at [64, 128]). Design: one warp per row.
  ``kl_bwd`` (same file) replaces ``_kl_bwd``. The ELBO paths fold both
  into reparam's launches (below); these serve the callers of kl alone.
* ``reparam`` (``csrc/reparam.cu``) replaces ``_reparam_fwd`` /
  ``_reparam_kernel``. Bound: launch latency (0.82 MB written at
  [25, 64, 128]). Design: Philox4x32-10 + Box-Muller inside the kernel,
  one counter (four outputs) a thread with one 32-bit remainder and one
  16-byte store; mean and logvar are read as [B, Z] for all S samples.
  ``reparam_kl_cuda`` launches the same kernel with KL blocks after the
  sample blocks: z and the per-row KL in one launch (counted as
  ``reparam``; ``kl`` counts the standalone kernel only). A key is two
  ints (seed, offset) passed by value, or an int64 device tensor
  [seed, offset] that the kernel reads (``StepKeys``: the train step's
  keys, which a captured step's replays rewrite in place).
  ``reparam_bwd`` (same file) replaces ``_reparam_bwd`` + ``_unbroadcast``
  and, given the KL's row gradient, ``_kl_bwd`` with the add that joins
  them: a float4 of each output a thread, the sample count a template
  argument up to 8, deterministic, no atomics, the separate kernels'
  bits. Its learned-prior variant (a second template of each
  ``__global__``, counted as ``reparam`` and ``reparam_bwd``) serves the
  ``vdvae`` family's layers (no TPU kernel: the reference has no such
  family): ``reparam_prior_cuda`` reads a layer's posterior and prior
  branch outputs q and p [B, 2Z, H, W] (channels_last: means then
  log-sigmas along the channels) in place, draws z [B, Z, H, W] from the
  same stream and sums the KL to N(pm, e^ps) per image, a block an image;
  ``reparam_prior_bwd_cuda`` gives dq and dp in q's layout, a quad a
  thread. Bound: memory (42 MB at the 32×32 layers of batch 128).
* ``groupnorm_gelu`` (``csrc/groupnorm_gelu.cu``) replaces
  ``apv_tpu/ops/groupnorm.py::_fwd`` / ``_gn_gelu_kernel``. Bound: memory,
  x in and y out (67.1 MB in bf16 at [256, 32, 32, 64]). Design: a
  cluster of blocks per image reading whole pixel rows in 16-byte runs,
  each block's per-group (count, mean, M2) meeting the others' in
  distributed shared memory and combined in rank order (other shapes: a
  block per (row, group), one channel a thread). ``groupnorm_gelu_bwd``
  (same file) replaces the rule ``_bwd`` in the same two layouts, on the
  same shapes; dgamma and dbeta as per-row partials summed in a fixed
  order. ``groupnorm_gelu_routes`` and ``groupnorm_gelu_bwd_routes`` count
  each direction's launches by the kernel that ran.
* ``rmsnorm_act`` (``csrc/rmsnorm_act.cu``) replaces no TPU kernel: XLA
  fused the reference's RMSNorm and activation into their neighbours, and
  the port's ResNet ran them as about nine eager kernels. Bound: memory,
  x in and y out (419 MB in bf16 at the IWAE chunk's [1600·1024, 64]).
  Design: C/8 lanes a row, 8 channels a lane in 16-byte loads, w in
  registers, the row's sum of squares by shuffles within the lanes
  (other widths: a scalar variant, a warp a row). ``rmsnorm_act_bwd``
  (same file) computes the rule written out in ``rmsnorm_act_bwd_plain``
  from x, dy and the forward's per-row rstd, dw as per-block partials
  summed in a fixed order. ``rmsnorm_act_routes`` and
  ``rmsnorm_act_bwd_routes`` count each direction's launches by the
  kernel that ran.
* ``conv3x3`` (``csrc/conv3x3.cu``) replaces
  ``scripts/conv_microbench.py::pallas_conv``. Bound: bytes at the probe's
  stage 1 (100.7 MB in bf16 with the f32 out), bf16 tensor-core operations
  at stages 2-3 (19.3 GFLOP at each shape). Design: an implicit GEMM on
  the tensor cores (``conv3x3_wgmma``: wgmma fed by TMA boxes of x and w
  through an mbarrier ring of 128-byte-swizzled stages, a producer thread
  and two consumer warpgroups, persistent; bf16, or 3xTF32 for f32) where
  Cin and Cout are multiples of 8, else f32 FMAs over shared-memory tiles
  (``conv3x3_simt``); ``conv3x3_route`` states the rule.

The wrappers (``*_cuda``) take CUDA tensors only: they check device, dtype,
shape and contiguity, allocate the outputs with ``torch.empty``, launch on
the current stream, raise on a nonzero ``cudaError_t``, and add one to
``launches[name]`` per launch. They record no gradient, so an input that
requires grad raises: the differentiable path is ``ops/dispatch.py``, whose
``torch.autograd.Function``s pair each forward kernel with its backward
kernel and hand both detached tensors.

The plain versions (``*_plain``) compute the same functions with torch
ops. The dispatch layer sends CPU tensors to the forward ones (autograd
differentiates them there); the backward ones write out the JAX rules and
serve the tests and ``chip_smoke.py``, which holds each kernel against its
plain version on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from apv_tpu_torch.core import distributions as D

# Launch count per kernel, incremented by the wrappers only.
launches: dict[str, int] = {
    "reparam": 0, "kl": 0, "disc_logistic": 0, "bernoulli": 0,
    "reparam_bwd": 0, "kl_bwd": 0, "bernoulli_bwd": 0,
    "disc_logistic_bwd": 0, "groupnorm_gelu": 0, "groupnorm_gelu_bwd": 0,
    "conv3x3": 0, "rmsnorm_act": 0, "rmsnorm_act_bwd": 0}
# conv3x3's launches by the kernel that ran (``conv3x3_route``'s names)
conv3x3_routes: dict[str, int] = {"wgmma": 0, "simt": 0}
# groupnorm_gelu's and groupnorm_gelu_bwd's launches by the kernel that
# ran, as the C entry points report it (``groupnorm_gelu_image`` or
# ``_rows``; ``groupnorm_gelu_bwd_image`` or ``_rows``)
GN_KERNELS = ("image", "rows")
groupnorm_gelu_routes: dict[str, int] = dict.fromkeys(GN_KERNELS, 0)
groupnorm_gelu_bwd_routes: dict[str, int] = dict.fromkeys(GN_KERNELS, 0)
# rmsnorm_act's and rmsnorm_act_bwd's launches by the kernel that ran, as
# the C entry points report it (``rmsnorm_act_rows`` or ``_rows_scalar``;
# ``rmsnorm_act_bwd_rows`` or ``_bwd_rows_scalar``)
RMS_KERNELS = ("vector", "scalar")
rmsnorm_act_routes: dict[str, int] = dict.fromkeys(RMS_KERNELS, 0)
rmsnorm_act_bwd_routes: dict[str, int] = dict.fromkeys(RMS_KERNELS, 0)


# every host counter of the wrappers (the launches and the routes), which
# a replayed train step advances by what its capture counted
# (``training/graph.py``); a harness that counts the step's calls of its
# own adds its dict here, so that replays advance it too
COUNTERS = [launches, conv3x3_routes, groupnorm_gelu_routes,
            groupnorm_gelu_bwd_routes, rmsnorm_act_routes,
            rmsnorm_act_bwd_routes]


def reset_launches() -> None:
    for counts in COUNTERS:
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# wrapper plumbing
# ---------------------------------------------------------------------------

def _check(name: str, *tensors: torch.Tensor) -> None:
    """Device, dtype, contiguity and no grad for all; equal shapes."""
    _check_each(name, *tensors)
    first = tensors[0]
    for t in tensors[1:]:
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{name}: inputs differ in shape or device: "
                             f"{tuple(first.shape)}@{first.device} vs "
                             f"{tuple(t.shape)}@{t.device}")


def _check_each(name: str, *tensors: torch.Tensor) -> None:
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the raw CUDA wrapper is forward only and records no "
            "gradient; differentiate through apv_tpu_torch.ops (whose "
            "autograd.Function pairs it with its backward kernel), or call "
            "it under torch.inference_mode() or on detached tensors")
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: CUDA kernel got a tensor on "
                             f"{t.device}; the plain version takes CPU ones")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expects float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


def _x_rows(name: str, x: torch.Tensor, params: torch.Tensor) -> int:
    """x's rows B where ``params`` has R rows: B divides R, the rest of
    the shapes are equal. Row r of ``params`` pairs with x's row r % B."""
    if (x.shape[1:] != params.shape[1:] or x.dim() == 0
            or (x.shape[0] == 0) != (params.shape[0] == 0)
            or (x.shape[0] and params.shape[0] % x.shape[0])):
        raise ValueError(f"{name}: x {tuple(x.shape)} does not pair with "
                         f"parameters {tuple(params.shape)}: x needs their "
                         "trailing shape and a row count B that divides "
                         "theirs (row r reads x row r % B)")
    return x.shape[0]


def _check_x(name: str, x: torch.Tensor, params: torch.Tensor) -> int:
    """The CUDA wrappers' x: checked as every input, on the parameters'
    device, paired with them by ``_x_rows``."""
    _check_each(name, x)
    if x.device != params.device:
        raise ValueError(f"{name}: inputs differ in device: x on {x.device}, "
                         f"parameters on {params.device}")
    return _x_rows(name, x, params)


def expand_rows(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """x [B, ...] repeated to ``like``'s R = S·B rows, sample-major (row r
    is x's row r % B); x itself when B = R."""
    b = _x_rows("expand_rows", x, like)
    if b == like.shape[0]:
        return x
    s = like.shape[0] // b
    return x.unsqueeze(0).expand((s,) + tuple(x.shape)).reshape(like.shape)


def _check_row_grad(name: str, g: torch.Tensor,
                    rows_like: torch.Tensor) -> None:
    """g is the [rows] incoming gradient of a per-row reduction."""
    _check_each(name, g)
    if g.shape != rows_like.shape[:1] or g.device != rows_like.device:
        raise ValueError(f"{name}: gradient {tuple(g.shape)}@{g.device} does "
                         f"not match rows {tuple(rows_like.shape[:1])}@"
                         f"{rows_like.device}")


def _rows_2d(name: str, t: torch.Tensor) -> tuple[int, int]:
    if t.dim() != 2:
        raise ValueError(f"{name}: expects [rows, E], got {tuple(t.shape)}")
    return t.shape[0], t.shape[1]


def _launch(name: str, fn, *args, device: torch.device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = fn(*args, stream)
    if status != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{status}")
    launches[name] += 1


def _lib():
    from apv_tpu_torch.ops import _build
    return _build.library()


# ---------------------------------------------------------------------------
# bernoulli
# ---------------------------------------------------------------------------

def bernoulli_plain(x: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Per-row sum of x·l − softplus(l) -> [rows]; x may have B rows where
    the logits have S·B (``expand_rows``)."""
    ll = D.bernoulli_logpmf(expand_rows(x, logits), logits)
    return ll.reshape(ll.shape[0], -1).sum(dim=-1)


def bernoulli_cuda(x: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Kernel version of ``bernoulli_plain`` on f32 logits [rows, E] and x
    [B, E], B dividing rows (row r reads x row r % B)."""
    _check("bernoulli", logits)
    rows, event = _rows_2d("bernoulli", logits)
    x_rows = _check_x("bernoulli", x, logits)
    out = torch.empty(rows, dtype=torch.float32, device=logits.device)
    if rows:
        _launch("bernoulli", _lib().apv_bernoulli, x.data_ptr(),
                logits.data_ptr(), out.data_ptr(), rows, event, x_rows,
                device=logits.device)
    return out


def _per_row(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return g.reshape((g.shape[0],) + (1,) * (like.dim() - 1))


def bernoulli_bwd_plain(g: torch.Tensor, x: torch.Tensor,
                        logits: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_bernoulli_bwd``: (dx, dlogits) = (g·l, g·(x − σ(l))), g per row."""
    gb = _per_row(g, x)
    return gb * logits, gb * (x - torch.sigmoid(logits))


def bernoulli_bwd_cuda(g: torch.Tensor, x: torch.Tensor,
                       logits: torch.Tensor, *, want_dx: bool = True
                       ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Kernel version of ``bernoulli_bwd_plain`` on f32 g [rows] and x,
    logits [rows, E]; dx is None unless ``want_dx``."""
    _check("bernoulli_bwd", x, logits)
    _check_row_grad("bernoulli_bwd", g, x)
    rows, event = _rows_2d("bernoulli_bwd", x)
    dl = torch.empty_like(logits)
    dx = torch.empty_like(x) if want_dx else None
    if rows:
        _launch("bernoulli_bwd", _lib().apv_bernoulli_bwd, g.data_ptr(),
                x.data_ptr(), logits.data_ptr(),
                None if dx is None else dx.data_ptr(), dl.data_ptr(), rows,
                event, device=x.device)
    return dx, dl


# ---------------------------------------------------------------------------
# disc_logistic
# ---------------------------------------------------------------------------

def disc_logistic_plain(x: torch.Tensor, mean: torch.Tensor,
                        log_scale: torch.Tensor,
                        bin_size: float = 1.0 / 255.0) -> torch.Tensor:
    """Per-row sum of the discretized-logistic log pmf -> [rows]; x may have
    B rows where mean and log_scale have S·B (``expand_rows``)."""
    ll = D.discretized_logistic_logpmf(expand_rows(x, mean), mean, log_scale,
                                       bin_size=bin_size)
    return ll.reshape(ll.shape[0], -1).sum(dim=-1)


def disc_logistic_cuda(x: torch.Tensor, mean: torch.Tensor,
                       log_scale: torch.Tensor,
                       bin_size: float = 1.0 / 255.0) -> torch.Tensor:
    """Kernel version of ``disc_logistic_plain`` on f32 mean, log_scale
    [rows, E] and x [B, E], B dividing rows (row r reads x row r % B)."""
    _check("disc_logistic", mean, log_scale)
    rows, event = _rows_2d("disc_logistic", mean)
    x_rows = _check_x("disc_logistic", x, mean)
    out = torch.empty(rows, dtype=torch.float32, device=mean.device)
    if rows:
        _launch("disc_logistic", _lib().apv_disc_logistic, x.data_ptr(),
                mean.data_ptr(), log_scale.data_ptr(), out.data_ptr(), rows,
                event, x_rows, float(bin_size), device=mean.device)
    return out


def disc_logistic_bwd_plain(g: torch.Tensor, x: torch.Tensor,
                            mean: torch.Tensor, log_scale: torch.Tensor,
                            bin_size: float = 1.0 / 255.0
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``_disc_logistic_bwd`` written out: g per row -> (dx, dmean,
    dlog_scale), each of x's shape.

    With a = (x − μ + h)/s, b = (x − μ − h)/s and t = bin/s: interior
    dμ = −(1 − σ(b) − σ(a))/s and dls = a·σ(a) − b·(1 − σ(b)) − t/(1 −
    e^{−t}) (1 + t/2 for t ≤ 1e-4); low edge (x ≤ h) dμ = −σ(−a)/s, dls =
    −a·σ(−a); high edge (x ≥ 1 − h) dμ = σ(b)/s, dls = b·σ(b); dx = −dμ."""
    x, mu, ls = (t.to(torch.float32) for t in (x, mean, log_scale))
    inv_s = torch.exp(-ls)
    half = 0.5 * bin_size
    a = (x - mu + half) * inv_s
    b = (x - mu - half) * inv_s
    t = bin_size * inv_s
    sig_a, sig_b = torch.sigmoid(a), torch.sigmoid(b)
    dmu_int = -inv_s * (1.0 - sig_b - sig_a)
    t_term = torch.where(t > 1e-4, t / -torch.expm1(-torch.clamp_min(t, 1e-4)),
                         1.0 + 0.5 * t)
    dls_int = a * sig_a - b * (1.0 - sig_b) - t_term
    is_low = x <= 0.0 + half
    is_high = x >= 1.0 - half
    dmu = torch.where(is_low, -inv_s * torch.sigmoid(-a),
                      torch.where(is_high, inv_s * sig_b, dmu_int))
    dls = torch.where(is_low, -a * torch.sigmoid(-a),
                      torch.where(is_high, b * sig_b, dls_int))
    gb = _per_row(g, x).to(torch.float32)
    return -gb * dmu, gb * dmu, gb * dls


def disc_logistic_bwd_cuda(g: torch.Tensor, x: torch.Tensor,
                           mean: torch.Tensor, log_scale: torch.Tensor,
                           bin_size: float = 1.0 / 255.0, *,
                           want_dx: bool = True
                           ) -> tuple[torch.Tensor | None, torch.Tensor,
                                      torch.Tensor]:
    """Kernel version of ``disc_logistic_bwd_plain`` on f32 g [rows] and x,
    mean, log_scale [rows, E]; dx is None unless ``want_dx``."""
    _check("disc_logistic_bwd", x, mean, log_scale)
    _check_row_grad("disc_logistic_bwd", g, x)
    rows, event = _rows_2d("disc_logistic_bwd", x)
    dmean, dls = torch.empty_like(mean), torch.empty_like(log_scale)
    dx = torch.empty_like(x) if want_dx else None
    if rows:
        _launch("disc_logistic_bwd", _lib().apv_disc_logistic_bwd,
                g.data_ptr(), x.data_ptr(), mean.data_ptr(),
                log_scale.data_ptr(), None if dx is None else dx.data_ptr(),
                dmean.data_ptr(), dls.data_ptr(), rows, event,
                float(bin_size), device=x.device)
    return dx, dmean, dls


# ---------------------------------------------------------------------------
# kl
# ---------------------------------------------------------------------------

def kl_plain(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Per-row KL(q || N(0, I)) -> [rows]."""
    kl = D.gaussian_kl_standard(mean, logvar)
    return kl.reshape(kl.shape[0], -1).sum(dim=-1)


def kl_cuda(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Kernel version of ``kl_plain`` on f32 [rows, Z] inputs."""
    _check("kl", mean, logvar)
    rows, event = _rows_2d("kl", mean)
    out = torch.empty(rows, dtype=torch.float32, device=mean.device)
    if rows:
        _launch("kl", _lib().apv_kl, mean.data_ptr(), logvar.data_ptr(),
                out.data_ptr(), rows, event, device=mean.device)
    return out


def kl_bwd_plain(g: torch.Tensor, mean: torch.Tensor, logvar: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_kl_bwd``: (dmean, dlogvar) = (g·μ, g·0.5·(e^lv − 1)), g per row."""
    gb = _per_row(g, mean)
    return gb * mean, gb * 0.5 * (torch.exp(logvar) - 1.0)


def kl_bwd_cuda(g: torch.Tensor, mean: torch.Tensor, logvar: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel version of ``kl_bwd_plain`` on f32 g [rows] and [rows, Z]."""
    _check("kl_bwd", mean, logvar)
    _check_row_grad("kl_bwd", g, mean)
    rows, event = _rows_2d("kl_bwd", mean)
    dmean, dlogvar = torch.empty_like(mean), torch.empty_like(logvar)
    if rows:
        _launch("kl_bwd", _lib().apv_kl_bwd, g.data_ptr(), mean.data_ptr(),
                logvar.data_ptr(), dmean.data_ptr(), dlogvar.data_ptr(), rows,
                event, device=mean.device)
    return dmean, dlogvar


# ---------------------------------------------------------------------------
# reparam: Philox4x32-10 + Box-Muller
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_TWO_PI_F32 = 6.2831855               # float32 nearest to 2*pi


def _mulhilo32(a, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a*b for a, b < 2^32, in int64 without
    overflow: b is multiplied by a's 16-bit halves (< 2^48 each); ``a`` is
    an int or an int64 tensor broadcasting against b."""
    t_hi = (a >> 16) * b
    t_lo = (a & 0xFFFF) * b
    lo = (((t_hi & 0xFFFF) << 16) + t_lo) & _MASK32
    hi = (t_hi + (t_lo >> 16)) >> 16
    return hi, lo


def _philox_pairs(x: torch.Tensor, y: torch.Tensor, key: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ten rounds on the words as two stacked pairs, x = (c0, c2)
    (the multiplied words) and y = (c1, c3), each [2, ...]; ``key`` the
    int64 [2] key. One round is x ← swap(hi(M·x)) ^ y ^ k_r, y ←
    swap(lo(M·x)), with k_r = k + r·W mod 2^32: the rounds of
    ``csrc/reparam.cu`` in a few ops each, so a traced graph stays
    small."""
    lead = (2,) + (1,) * (x.dim() - 1)
    m = torch.tensor(_PHILOX_M, dtype=torch.int64,
                     device=x.device).reshape(lead)
    w = torch.tensor(_PHILOX_W, dtype=torch.int64, device=x.device)
    rounds = torch.arange(10, dtype=torch.int64, device=x.device)[:, None]
    schedule = (key.to(x.device)[None, :] + rounds * w[None, :]) & _MASK32
    for k in schedule.reshape((10,) + lead).unbind(0):
        hi, lo = _mulhilo32(m, x)
        x, y = hi.flip(0) ^ y ^ k, lo.flip(0)
    return x, y


def philox4x32_10(counter: tuple[torch.Tensor, ...],
                  key: tuple[int | torch.Tensor, int | torch.Tensor]
                  ) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding 32-bit words (the same
    rounds as ``csrc/reparam.cu``); the key's words are ints or int64
    tensors (a seed read in a traced graph)."""
    c0, c1, c2, c3 = counter
    x, y = _philox_pairs(torch.stack([c0, c2]), torch.stack([c1, c3]),
                         _key_tensor(key, c0.device))
    return x[0], y[0], x[1], y[1]


def _key_tensor(key, device) -> torch.Tensor:
    k0, k1 = key
    if torch.is_tensor(k0):
        return torch.stack([k0, k1]).to(device=device, dtype=torch.int64)
    return torch.tensor([k0, k1], dtype=torch.int64, device=device)


def _uniform_open(bits: torch.Tensor) -> torch.Tensor:
    """23 random bits -> (m + 0.5) * 2^-23 in (0, 1), exact in float32."""
    return ((bits >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def _philox_words(total: int, seed: int | torch.Tensor, offset: int,
                  device: torch.device | str
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The words of counters 0..ceil(total/4) − 1 whose high words are
    ``offset``, under the key ``seed`` (an int, or an int64 tensor), as
    ``_philox_pairs``' (x, y): x = (c0, c2), y = (c1, c3)."""
    q = torch.arange((total + 3) // 4, dtype=torch.int64, device=device)
    full = torch.full_like
    x = torch.stack([q & _MASK32, full(q, offset & _MASK32)])
    y = torch.stack([q >> 32, full(q, (offset >> 32) & _MASK32)])
    return _philox_pairs(x, y, _key_tensor(
        (seed & _MASK32, (seed >> 32) & _MASK32), device))


def philox_uniforms(total: int, seed: int | torch.Tensor, offset: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """``total`` uniforms in (0, 1), four a counter (its words in order),
    from the stream of (seed, offset)."""
    x, y = _philox_words(total, seed, offset, device)
    words = torch.stack([x, y], dim=1)          # [(c0, c1), (c2, c3)]
    return _uniform_open(words.permute(2, 0, 1).reshape(-1))[:total]


def philox_normals(total: int, seed: int | torch.Tensor, offset: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The kernel's stream of ``total`` N(0, 1) draws for (seed, offset):
    Box-Muller on the word pairs (c0, c1) and (c2, c3), four draws a
    counter; ``seed`` may be an int64 tensor, so a traced graph draws
    from a seed it takes as input."""
    x, y = _philox_words(total, seed, offset, device)
    u1 = torch.clamp_min(_uniform_open(x), 1e-12)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI_F32 * _uniform_open(y)
    out = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return out.permute(1, 0, 2).reshape(-1)[:total]


class StepKeys:
    """The reparameterization keys of one train step, drawn ahead on the
    host in the step's order (``training/step.py``): the rows [seed,
    offset] of an int64 tensor on the step's device. Handed to an op in a
    generator's place, each of its draws takes the next row, which the
    kernel reads on the device."""

    def __init__(self, keys: torch.Tensor):
        self.keys, self.taken = keys, 0

    def next(self) -> torch.Tensor:
        if self.taken >= self.keys.shape[0]:
            raise RuntimeError(f"the step drew more than its "
                               f"{self.keys.shape[0]} reparameterization "
                               "keys")
        self.taken += 1
        return self.keys[self.taken - 1]


def draw_key(generator: torch.Generator | StepKeys | None
             ) -> tuple[int, int] | tuple[torch.Tensor, None]:
    """(seed, offset) for one reparam call, from one ``torch.randint`` on
    the caller's generator, on the generator's device (``None``: torch's
    default CPU generator); from ``StepKeys``, (its next key, None)."""
    if isinstance(generator, StepKeys):
        return generator.next(), None
    dev = generator.device if generator is not None else "cpu"
    seed, offset = torch.randint(0, 2 ** 63 - 1, (2,), generator=generator,
                                 dtype=torch.int64, device=dev).tolist()
    return seed, offset


def reparam_from_eps(mean: torch.Tensor, logvar: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """z = mean + exp(logvar/2) * eps (eps broadcasts over leading axes)."""
    return mean.to(torch.float32) + torch.exp(
        0.5 * logvar.to(torch.float32)) * eps


def _key_ints(seed, offset) -> tuple[int, int]:
    """The key as ints: ``seed`` and ``offset``, or the words of ``seed``,
    a key tensor [seed, offset] (``offset`` None)."""
    if torch.is_tensor(seed) and offset is None:
        seed, offset = seed.tolist()
    return seed, offset


def _key_args(name: str, seed, offset, device: torch.device
              ) -> tuple[int, int, int | None]:
    """A kernel's key arguments (seed, offset, device pointer or None):
    the ints by value, or a key tensor [seed, offset] on ``device`` (then
    ``offset`` is None) by its address."""
    if not torch.is_tensor(seed):
        return seed, offset, None
    if (offset is not None or seed.device != device
            or seed.dtype != torch.int64 or tuple(seed.shape) != (2,)
            or not seed.is_contiguous()):
        raise ValueError(f"{name}: a key tensor is an int64 [seed, offset] "
                         f"on {device}, got {seed.dtype} "
                         f"{tuple(seed.shape)} on {seed.device}")
    return 0, 0, seed.data_ptr()


def reparam_plain(mean: torch.Tensor, logvar: torch.Tensor, samples: int,
                  seed: int, offset: int) -> torch.Tensor:
    """[samples, *mean.shape] draws, the same stream as ``reparam_cuda``."""
    seed, offset = _key_ints(seed, offset)
    eps = philox_normals(samples * mean.numel(), seed, offset, mean.device)
    return reparam_from_eps(mean, logvar,
                            eps.reshape((samples,) + tuple(mean.shape)))


def _reparam_launch(mean: torch.Tensor, logvar: torch.Tensor, samples: int,
                    seed: int, offset: int, with_kl: bool
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    _check("reparam", mean, logvar)
    if samples < int(with_kl):
        raise ValueError(f"reparam: samples must be >= {int(with_kl)}, got "
                         f"{samples}")
    if with_kl and mean.dim() < 1:
        raise ValueError("reparam: the KL needs a row axis, got a scalar")
    z = torch.empty((samples,) + tuple(mean.shape), dtype=torch.float32,
                    device=mean.device)
    kl, event = None, 0
    if with_kl:      # [rows] (zeros where there is no element to sum)
        kl = (torch.empty if z.numel() else torch.zeros)(
            mean.shape[0], dtype=torch.float32, device=mean.device)
        event = mean.numel() // max(mean.shape[0], 1)
    key = _key_args("reparam", seed, offset, mean.device)
    if z.numel():
        _launch("reparam", _lib().apv_reparam, mean.data_ptr(),
                logvar.data_ptr(), z.data_ptr(),
                None if kl is None else kl.data_ptr(), samples,
                mean.numel(), event, *key, device=mean.device)
    return z, kl


def reparam_cuda(mean: torch.Tensor, logvar: torch.Tensor, samples: int,
                 seed: int, offset: int) -> torch.Tensor:
    """Kernel version of ``reparam_plain``: f32 [*shape] -> [samples, *shape]."""
    return _reparam_launch(mean, logvar, samples, seed, offset, False)[0]


def reparam_kl_plain(mean: torch.Tensor, logvar: torch.Tensor, samples: int,
                     seed: int, offset: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(``reparam_plain``, ``kl_plain``) of one posterior [rows, ...]."""
    return (reparam_plain(mean, logvar, samples, seed, offset),
            kl_plain(mean, logvar))


def reparam_kl_cuda(mean: torch.Tensor, logvar: torch.Tensor, samples: int,
                    seed: int, offset: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel version of ``reparam_kl_plain``: z [samples, *shape] and the
    per-row KL [rows] from one launch of the reparam kernel (counted as
    ``reparam``), z with ``reparam_cuda``'s bits and the KL with
    ``kl_cuda``'s."""
    return _reparam_launch(mean, logvar, samples, seed, offset, True)


def reparam_bwd_plain(g: torch.Tensor | None, z: torch.Tensor,
                      mean: torch.Tensor, g_kl: torch.Tensor | None = None,
                      logvar: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_reparam_bwd`` + ``_unbroadcast``: g and z [S, *shape], mean
    [*shape] -> (Σ_s g, Σ_s 0.5·g·(z − μ)), each of mean's shape; with
    ``g_kl`` [rows] (and ``logvar``), ``kl_bwd_plain``'s terms added, as
    autograd adds the two rules' outputs. ``g`` None: z had no gradient.

    The sums run over s = 0, 1, ... in order, as the kernel's do (a
    reduction in another order differs by a few ulps per sample)."""
    dmean, dlogvar = torch.zeros_like(mean), torch.zeros_like(mean)
    if g is not None:
        terms = g * 0.5 * (z - mean)
        for s in range(g.shape[0]):
            dmean, dlogvar = dmean + g[s], dlogvar + terms[s]
    if g_kl is not None:
        km, klv = kl_bwd_plain(g_kl, mean, logvar)
        dmean, dlogvar = dmean + km, dlogvar + klv
    return dmean, dlogvar


def reparam_bwd_cuda(g: torch.Tensor | None, z: torch.Tensor,
                     mean: torch.Tensor, g_kl: torch.Tensor | None = None,
                     logvar: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel version of ``reparam_bwd_plain`` on f32 tensors: one launch,
    with or without the KL's terms."""
    _check_each("reparam_bwd", *(t for t in (g, z, mean, g_kl, logvar)
                                 if t is not None))
    if g is not None:
        _check("reparam_bwd", g, z)
    if z.dim() < 1 or tuple(z.shape[1:]) != tuple(mean.shape) \
            or mean.device != z.device:
        raise ValueError(f"reparam_bwd: gradient {tuple(z.shape)} is not "
                         f"[S, *{tuple(mean.shape)}] on {mean.device}")
    event = 0
    if g_kl is not None:
        if logvar is None or mean.dim() < 1:
            raise ValueError("reparam_bwd: the KL's gradient needs logvar "
                             "and a row axis")
        _check("reparam_bwd", mean, logvar)
        _check_row_grad("reparam_bwd", g_kl, mean)
        event = mean.numel() // max(mean.shape[0], 1)
    dmean, dlogvar = torch.empty_like(mean), torch.empty_like(mean)
    if mean.numel():
        kl_ptrs = ((None, None) if g_kl is None
                   else (logvar.data_ptr(), g_kl.data_ptr()))
        _launch("reparam_bwd", _lib().apv_reparam_bwd,
                None if g is None else g.data_ptr(), z.data_ptr(),
                mean.data_ptr(), *kl_ptrs, dmean.data_ptr(),
                dlogvar.data_ptr(), 0 if g is None else g.shape[0],
                mean.numel(), event, device=mean.device)
    return dmean, dlogvar


# ---------------------------------------------------------------------------
# reparam under a learned prior: VDVAE's layers
# ---------------------------------------------------------------------------
# q and p are one layer's posterior and prior branch outputs [B, 2Z, H, W]
# (channels_last, float32): channels 0..Z-1 the means, Z..2Z-1 the
# log-sigmas. z is [B, Z, H, W] in channels_last memory, drawn in the order
# of that memory from ``reparam_plain``'s stream; kl is the per-image sum
# of the elementwise KL( N(qm, e^qs) || N(pm, e^ps) ).

def _split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    z = t.shape[1] // 2
    return t[:, :z].to(torch.float32), t[:, z:].to(torch.float32)


def prior_kl_terms(qm: torch.Tensor, qs: torch.Tensor, pm: torch.Tensor,
                   ps: torch.Tensor) -> torch.Tensor:
    """Elementwise KL( N(qm, e^qs) || N(pm, e^ps) ) from log-sigmas."""
    d = qm - pm
    return (-0.5 + ps - qs
            + 0.5 * (torch.exp(2.0 * qs) + d * d) * torch.exp(-2.0 * ps))


def prior_noise(zshape, seed: int, offset: int, device) -> torch.Tensor:
    """The stream's draws for z of shape ``zshape`` (B, Z, H, W), laid out
    as its channels_last memory."""
    b, z, h, w = zshape
    eps = philox_normals(b * z * h * w, seed, offset, device)
    return eps.reshape(b, h, w, z).permute(0, 3, 1, 2)


def reparam_prior_from_eps(q: torch.Tensor, p: torch.Tensor,
                           eps: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(z, kl): z = qm + e^qs·eps and the per-image KL sum [B]."""
    (qm, qs), (pm, ps) = _split(q), _split(p)
    z = qm + torch.exp(qs) * eps
    return z, prior_kl_terms(qm, qs, pm, ps).sum(dim=(1, 2, 3))


def reparam_prior_plain(q: torch.Tensor, p: torch.Tensor, seed: int,
                        offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``reparam_prior_from_eps`` on the draws of the key (seed, offset)."""
    seed, offset = _key_ints(seed, offset)
    zshape = (q.shape[0], q.shape[1] // 2) + tuple(q.shape[2:])
    return reparam_prior_from_eps(q, p, prior_noise(zshape, seed, offset,
                                                    q.device))


def reparam_prior_bwd_plain(g: torch.Tensor | None, z: torch.Tensor,
                            q: torch.Tensor, p: torch.Tensor,
                            g_kl: torch.Tensor | None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rule of ``reparam_prior_plain``: g [B, Z, H, W] (z's gradient)
    and g_kl [B] -> (dq, dp) of q's and p's shape. ``g`` or ``g_kl`` None:
    that output had no gradient."""
    (qm, qs), (pm, ps) = _split(q), _split(p)
    d, inv = qm - pm, torch.exp(-2.0 * ps)
    zero = torch.zeros_like(qm)
    gz = zero if g is None else g.to(torch.float32)
    gk = zero if g_kl is None else g_kl.to(torch.float32)[:, None, None,
                                                            None]
    dqm = gz + gk * (d * inv)
    dqs = gz * (z - qm) + gk * (torch.exp(2.0 * qs) * inv - 1.0)
    dpm = -(gk * (d * inv))
    dps = gk * (1.0 - (torch.exp(2.0 * qs) + d * d) * inv)
    return torch.cat([dqm, dqs], dim=1), torch.cat([dpm, dps], dim=1)


def _check_prior(name: str, *tensors: torch.Tensor) -> None:
    """[B, 2Z, H, W] float32 CUDA tensors in channels_last memory, Z a
    multiple of 4, alike in shape and device."""
    if any(t.requires_grad for t in tensors):
        _check_each(name, *tensors)          # raises the common message
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: CUDA kernel got a tensor on "
                             f"{t.device}; the plain version takes CPU ones")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expects float32, got {t.dtype}")
        if (t.dim() != 4 or t.shape != first.shape or t.device != first.device
                or not t.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError(f"{name}: expects alike [B, 2Z, H, W] tensors "
                             f"in channels_last memory, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if first.shape[1] % 8:
        raise ValueError(f"{name}: 2Z = {first.shape[1]} channels; the "
                         "kernel takes Z a multiple of 4")


def reparam_prior_cuda(q: torch.Tensor, p: torch.Tensor, seed: int,
                       offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel version of ``reparam_prior_plain``: one launch of the reparam
    kernel's learned-prior variant (counted as ``reparam``) reads q and p
    in place and writes z and the per-image KL."""
    _check_prior("reparam", q, p)
    key = _key_args("reparam", seed, offset, q.device)
    b, c, h, w = q.shape
    z = torch.empty((b, c // 2, h, w), dtype=torch.float32, device=q.device,
                    memory_format=torch.channels_last)
    kl = torch.zeros(b, dtype=torch.float32, device=q.device) if \
        z.numel() == 0 else torch.empty(b, dtype=torch.float32,
                                        device=q.device)
    if z.numel():
        _launch("reparam", _lib().apv_reparam_prior, q.data_ptr(),
                p.data_ptr(), z.data_ptr(), kl.data_ptr(), b,
                z.numel() // b, c // 2, *key, device=q.device)
    return z, kl


def reparam_prior_bwd_cuda(g: torch.Tensor | None, z: torch.Tensor,
                           q: torch.Tensor, p: torch.Tensor,
                           g_kl: torch.Tensor | None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel version of ``reparam_prior_bwd_plain``: one launch (counted
    as ``reparam_bwd``) gives dq and dp in q's layout."""
    _check_prior("reparam_bwd", q, p)
    b, c, h, w = q.shape
    zshape = (b, c // 2, h, w)
    for t in (z,) + (() if g is None else (g,)):
        _check_each("reparam_bwd", t.permute(0, 2, 3, 1))
        if tuple(t.shape) != zshape or t.device != q.device:
            raise ValueError(f"reparam_bwd: z and its gradient must be "
                             f"{zshape} on {q.device}, got "
                             f"{tuple(t.shape)}@{t.device}")
    if g_kl is not None:
        _check_row_grad("reparam_bwd", g_kl, q)
    dq = torch.empty_like(q, memory_format=torch.channels_last)
    dp = torch.empty_like(p, memory_format=torch.channels_last)
    if q.numel():
        _launch("reparam_bwd", _lib().apv_reparam_prior_bwd,
                None if g is None else g.data_ptr(), z.data_ptr(),
                q.data_ptr(), p.data_ptr(),
                None if g_kl is None else g_kl.data_ptr(), dq.data_ptr(),
                dp.data_ptr(), b, z.numel() // b, c // 2, device=q.device)
    return dq, dp


# ---------------------------------------------------------------------------
# groupnorm_gelu: fused GroupNorm + tanh-GELU over NHWC, and its rule
# ---------------------------------------------------------------------------

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_GN_DTYPES = (torch.float32, torch.bfloat16)


def gelu_tanh(v: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU (``jax.nn.gelu(approximate=True)``,
    flax's default)."""
    return 0.5 * v * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (v + 0.044715 * v ** 3)))


def gelu_tanh_grad(v: torch.Tensor) -> torch.Tensor:
    """d/dv of ``gelu_tanh``."""
    th = torch.tanh(_SQRT_2_OVER_PI * (v + 0.044715 * v ** 3))
    return 0.5 * (1.0 + th) + 0.5 * v * (1.0 - th ** 2) * _SQRT_2_OVER_PI \
        * (1.0 + 3 * 0.044715 * v ** 2)


def _group_shape(x: torch.Tensor, groups: int) -> tuple[int, int, int]:
    """(B, HW, C) of NHWC x; raise unless C % groups == 0."""
    if x.dim() != 4:
        raise ValueError(f"groupnorm_gelu: expects NHWC x, got "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    if groups < 1 or c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    return b, h * w, c


def groupnorm_gelu_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, groups: int = 8,
                         eps: float = 1e-6
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_reference`` with the residuals of ``_fwd``: (y in x's dtype, mean
    [B, G], rstd [B, G]); float32 statistics, two-pass variance."""
    b, hw, c = _group_shape(x, groups)
    xf = x.to(torch.float32).reshape(b, hw, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = ((xf - mean) * rstd).reshape(b, hw, c)
    y = gelu_tanh(xhat * gamma.to(torch.float32) + beta.to(torch.float32))
    return (y.reshape(x.shape).to(x.dtype), mean.reshape(b, groups),
            rstd.reshape(b, groups))


def groupnorm_gelu_bwd_plain(dy: torch.Tensor, x: torch.Tensor,
                             gamma: torch.Tensor, beta: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             groups: int = 8
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The rule ``_bwd`` written out: (dx in x's dtype, dgamma, dbeta in
    float32). With y_pre = xhat·γ + β: dy_pre = dy·gelu'(y_pre), dgamma =
    Σ dy_pre·xhat, dbeta = Σ dy_pre, dxhat = dy_pre·γ and dx = rstd·(dxhat
    − mean_g(dxhat) − xhat·mean_g(dxhat·xhat))."""
    b, hw, c = _group_shape(x, groups)
    cg = c // groups
    xf = x.to(torch.float32).reshape(b, hw, groups, cg)
    xhat = (xf - mean[:, None, :, None]) * rstd[:, None, :, None]
    xhat2 = xhat.reshape(b, hw, c)
    g32, b32 = gamma.to(torch.float32), beta.to(torch.float32)
    y_pre = xhat2 * g32 + b32
    dy_pre = dy.to(torch.float32).reshape(b, hw, c) * gelu_tanh_grad(y_pre)
    dgamma = (dy_pre * xhat2).sum(dim=(0, 1))
    dbeta = dy_pre.sum(dim=(0, 1))
    dxhat = (dy_pre * g32).reshape(b, hw, groups, cg)
    m1 = dxhat.mean(dim=(1, 3), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(1, 3), keepdim=True)
    dx = rstd[:, None, :, None] * (dxhat - m1 - xhat * m2)
    return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta


def _check_gn(name: str, x: torch.Tensor, *f32: torch.Tensor) -> None:
    """x bf16 or f32 NHWC, the rest f32 (gamma, beta or statistics); all
    CUDA, contiguous and without grad."""
    if x.dtype not in _GN_DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.requires_grad:
        _check_each(name, x)              # raises the no-grad message
    if x.device.type != "cuda":
        raise ValueError(f"{name}: CUDA kernel got a tensor on {x.device}; "
                         "the plain version takes CPU ones")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expects contiguous NHWC x (a "
                         "channels_last NCHW tensor's permute(0, 2, 3, 1))")
    _check_each(name, *f32)
    if any(t.device != x.device for t in f32):
        raise ValueError(f"{name}: inputs on different devices")


def groupnorm_gelu_cuda(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, groups: int = 8,
                        eps: float = 1e-6
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel version of ``groupnorm_gelu_plain``: NHWC x (bf16 or f32),
    f32 gamma and beta [C] -> (y, mean [B, G], rstd [B, G]). The C entry
    point picks the kernel by the rule of the backward and reports it; each
    launch adds one to ``groupnorm_gelu_routes`` under the kernel that
    ran."""
    b, hw, c = _group_shape(x, groups)
    _check_gn("groupnorm_gelu", x, gamma, beta)
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"groupnorm_gelu: gamma, beta must be [{c}], got "
                         f"{tuple(gamma.shape)}, {tuple(beta.shape)}")
    y = torch.empty_like(x)
    mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if x.numel():
        ran = ctypes.c_int(-1)
        _launch("groupnorm_gelu", _lib().apv_groupnorm_gelu, x.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), b, hw, c, groups,
                float(eps), int(x.dtype == torch.bfloat16),
                ctypes.byref(ran), device=x.device)
        groupnorm_gelu_routes[GN_KERNELS[ran.value]] += 1
    return y, mean, rstd


def groupnorm_gelu_bwd_cuda(dy: torch.Tensor, x: torch.Tensor,
                            gamma: torch.Tensor, beta: torch.Tensor,
                            mean: torch.Tensor, rstd: torch.Tensor,
                            groups: int = 8
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Kernel version of ``groupnorm_gelu_bwd_plain``: dy and x of one
    dtype and shape, the forward's f32 residuals -> (dx, dgamma, dbeta).
    The C entry point picks the kernel (by widths, alignment and the
    image's size) and reports it; each launch adds one to
    ``groupnorm_gelu_bwd_routes`` under the kernel that ran."""
    b, hw, c = _group_shape(x, groups)
    _check_gn("groupnorm_gelu_bwd", x, gamma, beta, mean, rstd)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous() or dy.requires_grad:
        raise ValueError("groupnorm_gelu_bwd: dy must match x in shape, "
                         "dtype and device, contiguous and without grad")
    if gamma.shape != (c,) or beta.shape != (c,) \
            or mean.shape != (b, groups) or rstd.shape != (b, groups):
        raise ValueError("groupnorm_gelu_bwd: gamma, beta [C] and mean, "
                         "rstd [B, G] expected")
    dx = torch.empty_like(x)
    partials = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    if c:
        ran = ctypes.c_int(-1)            # stays -1 when B = 0
        _launch("groupnorm_gelu_bwd", _lib().apv_groupnorm_gelu_bwd,
                dy.data_ptr(), x.data_ptr(), gamma.data_ptr(),
                beta.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                dx.data_ptr(), partials[0].data_ptr(),
                partials[1].data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                b, hw, c, groups, int(x.dtype == torch.bfloat16),
                ctypes.byref(ran), device=x.device)
        if ran.value >= 0:
            groupnorm_gelu_bwd_routes[GN_KERNELS[ran.value]] += 1
    return dx, dgamma, dbeta


# ---------------------------------------------------------------------------
# rmsnorm_act: RMSNorm over the last axis followed by the activation, and
# its rule
# ---------------------------------------------------------------------------

# The models' activations by configuration name (flax's default gelu is the
# tanh approximation), each as the eager chain computes it.
ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_sigmoid": lambda x: x * torch.sigmoid(1.702 * x),
    "silu": F.silu,
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.2),
}
# the kernel's template argument for each (csrc/rmsnorm_act.cu's Act)
RMS_ACTIVATIONS = ("silu", "gelu", "gelu_sigmoid", "relu", "leaky_relu")
# rows of per-block dw partials the backward may use (its grid's cap)
RMS_PARTIAL_ROWS = 2048


def _sigmoid_grad(v: torch.Tensor, k: float) -> torch.Tensor:
    """d/dv of v·sigmoid(k·v)."""
    s = torch.sigmoid(k * v)
    return s + v * k * s * (1.0 - s)


# act'(v) of each activation, in float32
ACTIVATION_GRADS = {
    "gelu": gelu_tanh_grad,
    "gelu_sigmoid": lambda v: _sigmoid_grad(v, 1.702),
    "silu": lambda v: _sigmoid_grad(v, 1.0),
    "relu": lambda v: (v > 0).to(v.dtype),
    "leaky_relu": lambda v: torch.where(v > 0, 1.0, 0.2).to(v.dtype),
}


def activation_id(activation: str) -> int:
    """The kernel's index of ``activation``; ValueError for a name the
    models do not have."""
    if activation not in RMS_ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; have "
                         f"{sorted(RMS_ACTIVATIONS)}")
    return RMS_ACTIVATIONS.index(activation)


def rms_rstd(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """1/sqrt(mean(x²) + eps) over the last axis, float32, x's leading
    shape: the residual the forward kernel writes."""
    ms = x.to(torch.float32).square().mean(dim=-1)
    return torch.rsqrt(ms + eps)


def rmsnorm_act_plain(x: torch.Tensor, w: torch.Tensor, activation: str,
                      eps: float = 1e-6) -> torch.Tensor:
    """act(RMSNorm(x)) over x's last axis, as the ResNet's eager chain
    computes it: float32 statistics, n = x32·(rsqrt(ms + eps)·w) rounded
    to x's dtype, then the activation on n in x's dtype."""
    activation_id(activation)
    x32 = x.to(torch.float32)
    ms = x32.square().mean(dim=-1, keepdim=True)
    n = x32 * (torch.rsqrt(ms + eps) * w)
    return ACTIVATIONS[activation](n.to(x.dtype))


def rmsnorm_act_bwd_plain(dy: torch.Tensor, x: torch.Tensor,
                          w: torch.Tensor, rstd: torch.Tensor,
                          activation: str
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rule written out: (dx in x's dtype, dw float32 [C]). With xh =
    x·rstd and n = x·(rstd·w) rounded to x's dtype: d = dy·act'(n), g =
    d·w, dx = rstd·(g − xh·mean_C(g·xh)), dw = Σ_rows d·xh."""
    activation_id(activation)
    c = x.shape[-1]
    x32, w32 = x.to(torch.float32), w.to(torch.float32)
    r = rstd.unsqueeze(-1)
    xh = x32 * r
    n = (x32 * (r * w32)).to(x.dtype).to(torch.float32)
    d = dy.to(torch.float32) * ACTIVATION_GRADS[activation](n)
    g = d * w32
    dx = r * (g - xh * (g * xh).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), (d * xh).reshape(-1, c).sum(dim=0)


def _check_rms(name: str, x: torch.Tensor, w: torch.Tensor,
               *f32: torch.Tensor) -> tuple[int, int]:
    """(rows, C) of x [..., C] (bf16 or f32, rows contiguous in C); w [C]
    and the rest float32; all CUDA, contiguous and without grad."""
    _check_gn(name, x, w, *f32)
    if x.dim() < 1 or x.shape[-1] == 0 or w.shape != x.shape[-1:]:
        raise ValueError(f"{name}: expects x [..., C] with C > 0 and w [C], "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    return x.numel() // x.shape[-1], x.shape[-1]


def rmsnorm_act_cuda(x: torch.Tensor, w: torch.Tensor, activation: str,
                     eps: float = 1e-6, want_rstd: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Kernel version of ``rmsnorm_act_plain`` on x [..., C] (NHWC: one
    pixel a row), f32 w [C] -> (y in x's dtype, rstd [...] float32 where
    ``want_rstd``, else None). The C entry point picks the kernel by C and
    alignment and reports it; each launch adds one to
    ``rmsnorm_act_routes`` under the kernel that ran."""
    act = activation_id(activation)
    rows, c = _check_rms("rmsnorm_act", x, w)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    rstd = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
            if want_rstd else None)
    if rows:
        ran = ctypes.c_int(-1)
        _launch("rmsnorm_act", _lib().apv_rmsnorm_act, x.data_ptr(),
                w.data_ptr(), y.data_ptr(),
                None if rstd is None else rstd.data_ptr(), rows, c,
                float(eps), act, int(x.dtype == torch.bfloat16),
                ctypes.byref(ran), device=x.device)
        rmsnorm_act_routes[RMS_KERNELS[ran.value]] += 1
    return y, rstd


def rmsnorm_act_bwd_cuda(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                         rstd: torch.Tensor, activation: str
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel version of ``rmsnorm_act_bwd_plain``: dy and x of one dtype
    and shape, f32 w [C] and the forward's rstd -> (dx, dw float32 [C]).
    Each launch adds one to ``rmsnorm_act_bwd_routes`` under the kernel
    that ran."""
    act = activation_id(activation)
    rows, c = _check_rms("rmsnorm_act_bwd", x, w, rstd)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous() or dy.requires_grad:
        raise ValueError("rmsnorm_act_bwd: dy must match x in shape, dtype "
                         "and device, contiguous and without grad")
    if rstd.shape != x.shape[:-1]:
        raise ValueError(f"rmsnorm_act_bwd: rstd must be "
                         f"{tuple(x.shape[:-1])}, got {tuple(rstd.shape)}")
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    partials = torch.empty((RMS_PARTIAL_ROWS, c), dtype=torch.float32,
                           device=x.device)
    dw = torch.empty(c, dtype=torch.float32, device=x.device)
    ran = ctypes.c_int(-1)                # stays -1 when there is no row
    _launch("rmsnorm_act_bwd", _lib().apv_rmsnorm_act_bwd, dy.data_ptr(),
            x.data_ptr(), w.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            partials.data_ptr(), RMS_PARTIAL_ROWS, dw.data_ptr(), rows, c,
            act, int(x.dtype == torch.bfloat16), ctypes.byref(ran),
            device=x.device)
    if ran.value >= 0:
        rmsnorm_act_bwd_routes[RMS_KERNELS[ran.value]] += 1
    return dx, dw


# ---------------------------------------------------------------------------
# conv3x3: 3x3 SAME stride-1 conv, NHWC x, HWIO w, f32 out
# ---------------------------------------------------------------------------

def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch ops: x and w widened to f32, then
    nine shifted [B·H·W, Cin] × [Cin, Cout] products summed in f32 ->
    [B, H, W, Cout] f32."""
    b, h, wd, c = x.shape
    xf = torch.nn.functional.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    wf = w.to(torch.float32)
    out = torch.zeros((b * h * wd, w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for ky in range(3):
        for kx in range(3):
            patch = xf[:, ky:ky + h, kx:kx + wd, :].reshape(-1, c)
            out = out + patch @ wf[ky, kx]
    return out.reshape(b, h, wd, w.shape[-1])


def conv3x3_route(cin: int, cout: int) -> str:
    """The kernel ``conv3x3_cuda`` launches for these widths: ``"wgmma"``
    (tensor cores) when Cin and Cout are multiples of 8, else ``"simt"``
    (f32 FMAs). Both dtypes follow the same rule."""
    return "wgmma" if cin % 8 == 0 and cout % 8 == 0 else "simt"


def conv3x3_kmajor(w: torch.Tensor) -> torch.Tensor:
    """HWIO w as the tensor-core kernel reads it: [Cout, 9·Cin], row n
    holding Wf[:, n] with k = (ky·3 + kx)·Cin + ci (a contiguous copy)."""
    return w.reshape(-1, w.shape[-1]).t().contiguous()


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel version of ``conv3x3_plain``: x [B, H, W, Cin] and w [3, 3,
    Cin, Cout], both bf16 or both f32, CUDA and contiguous -> f32 out.
    ``conv3x3_route`` picks the kernel by the widths alone; on f32 the
    tensor-core one reads ``conv3x3_kmajor(w)``, a copy made here (TF32
    wgmma takes K-major B only), on bf16 w itself. It reads x and w
    through TMA, whose base addresses must be 16-byte aligned: a view off
    that alignment is copied first. Each launch also adds one to
    ``conv3x3_routes`` under the kernel that ran."""
    if x.dtype not in _GN_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv3x3: x and w must both be float32 or both "
                        f"bfloat16, got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3: x [B,H,W,Cin] and w [3,3,Cin,Cout] "
                         f"expected, got {tuple(x.shape)}, {tuple(w.shape)}")
    for t in (x, w):
        if t.requires_grad:
            _check_each("conv3x3", t)     # raises the no-grad message
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"conv3x3: CUDA kernel got a tensor on "
                             f"{t.device}; the plain version takes CPU ones")
        if not t.is_contiguous():
            raise ValueError("conv3x3: expects contiguous NHWC x and HWIO w")
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty((b, h, wd, cout), dtype=torch.float32, device=x.device)
    if not out.numel():
        return out
    sizes = (b, h, wd, cin, cout, int(x.dtype == torch.bfloat16))
    route = conv3x3_route(cin, cout)
    if route == "wgmma":
        if x.data_ptr() % 16:             # TMA's base address: a fresh
            x = x.clone()                 # allocation is aligned
        wb = w if x.dtype == torch.bfloat16 else conv3x3_kmajor(w)
        if wb.data_ptr() % 16:
            wb = wb.clone()
        _launch("conv3x3", _lib().apv_conv3x3_wgmma, x.data_ptr(),
                wb.data_ptr(), out.data_ptr(), *sizes, device=x.device)
    else:
        _launch("conv3x3", _lib().apv_conv3x3_simt, x.data_ptr(),
                w.data_ptr(), out.data_ptr(), *sizes, device=x.device)
    conv3x3_routes[route] += 1
    return out
