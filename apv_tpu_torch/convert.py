"""Carry flax weights of ``apv_tpu`` models into the port's modules.

``params_from_flax`` maps a ``ResNetVAE`` or ``ConvVAE`` params tree (numpy
leaves; any tree of that structure, such as Adam's moments) to a state
dict of the port's model of the same family; ``d_params_from_flax`` does
the same for the discriminators (the latent D, spectrally normalized or
not, and the biadversarial pair). Layouts:

* Dense kernels are (in, out) in flax and (out, in) in torch;
* Conv kernels go HWIO -> OIHW;
* ConvTranspose kernels are flipped spatially and laid out (in, out, kh, kw),
  which makes ``F.conv_transpose2d(stride=2, padding=1)`` equal flax's
  'SAME' transposed conv;
* norm ``scale`` becomes ``weight``;
* the trained priors keep their layouts: ``gaussian_prior`` {mu,
  log_sigma} -> ``prior.mu``/``prior.log_sigma``, ``flow_prior.flow``
  {whiten, layers[i]} -> ``prior.whiten.*``/``prior.layers.i.*``.

``flow_from_flax`` carries an ex-post flow dict (``apv_tpu.core.flow``'s
tree) into the tensor dict that ``apv_tpu_torch.core.flow`` takes.

``train_state_from_flax`` carries a whole flax ``TrainState`` (the object,
or the orbax reader's tree of it, ``utils/checkpoint.py``) into
``TrainState.state_dict()``'s format: the parameters, the D, the EMA
shadow, and each optax ``chain(clip_by_global_norm, adam)`` state (under
``optax.MultiSteps`` its accumulator too) as ``ClippedAdam``'s, the
moments through the same maps as the parameters.

Flax names submodules by class and creation order (``Conv_0``,
``ResBlock_3``, ...); the stage structure is recovered from those counts.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_NORMS = ("RMSNorm", "GroupNorm")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(p) -> dict:
    return {"weight": _t(np.asarray(p["kernel"]).T), "bias": _t(p["bias"])}


def _conv(p) -> dict:
    return {"weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)),
            "bias": _t(p["bias"])}


def _conv_transpose(p) -> dict:
    k = np.asarray(p["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    return {"weight": _t(k), "bias": _t(p["bias"])}


def _norm(tree, index: int) -> dict:
    for cls in _NORMS:
        p = tree.get(f"{cls}_{index}")
        if p is not None:
            out = {"weight": _t(p["scale"])}
            if "bias" in p:
                out["bias"] = _t(p["bias"])
            return out
    return {}                                  # norm='none': no params


def _count(tree, cls: str) -> int:
    return sum(1 for name in tree if re.fullmatch(f"{cls}_\\d+", name))


def _put(sd: dict, prefix: str, params: dict) -> None:
    for name, value in params.items():
        sd[f"{prefix}.{name}"] = value


def _res_block(sd: dict, prefix: str, p) -> None:
    _put(sd, f"{prefix}.norm1", _norm(p, 0))
    _put(sd, f"{prefix}.conv1", _conv(p["Conv_0"]))
    _put(sd, f"{prefix}.norm2", _norm(p, 1))
    _put(sd, f"{prefix}.conv2", _conv(p["Conv_1"]))
    if "Conv_2" in p:
        _put(sd, f"{prefix}.shortcut", _conv(p["Conv_2"]))


def _stages(sd: dict, prefix: str, tree, n_stages: int, resample) -> None:
    n_blocks = _count(tree, "ResBlock")
    if n_blocks % n_stages:
        raise ValueError(f"{n_blocks} residual blocks do not split into "
                         f"{n_stages} stages")
    per = n_blocks // n_stages
    for i in range(n_stages):
        for j in range(per):
            _res_block(sd, f"{prefix}.stages.{i}.blocks.{j}",
                       tree[f"ResBlock_{i * per + j}"])
        if i < n_stages - 1:
            resample(sd, f"{prefix}.stages.{i}.resample", i)


def params_from_flax(flax_params) -> dict[str, torch.Tensor]:
    """flax ``ResNetVAE`` or ``ConvVAE`` params -> the port's state dict.

    The conv VAE's encoder holds a ``Dense_0`` trunk and no residual
    blocks; that tells the two families apart."""
    enc, dec = flax_params["encoder"], flax_params["decoder"]
    if "Dense_0" in enc:
        sd = _conv_vae(enc, dec)
    else:
        sd = _resnet_vae(enc, dec)
    sd.update(_prior(flax_params))
    return sd


def _prior(flax_params) -> dict[str, torch.Tensor]:
    """The trained prior's parameters (none for the standard prior)."""
    sd: dict[str, torch.Tensor] = {}
    if "gaussian_prior" in flax_params:
        _put(sd, "prior", {k: _t(v) for k, v in
                           flax_params["gaussian_prior"].items()})
    if "flow_prior" in flax_params:
        flow = flow_from_flax(flax_params["flow_prior"]["flow"])
        _put(sd, "prior.whiten", flow["whiten"])
        for i, layer in enumerate(flow["layers"]):
            _put(sd, f"prior.layers.{i}", layer)
    return sd


def flow_from_flax(flow) -> dict:
    """A flow params dict (numpy or JAX leaves) -> ``core/flow``'s dict of
    float32 tensors; other keys (the ex-post fit's ``flow_nll``) are
    dropped."""
    return {"whiten": {k: _t(flow["whiten"][k]) for k in ("mean", "log_std")},
            "layers": [{k: _t(v) for k, v in layer.items()}
                       for layer in flow["layers"]]}


def _resnet_vae(enc, dec) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}

    # encoder: Conv_0 is the stem, Conv_1.. the stride-2 downsamples
    n_stages = _count(enc, "Conv")
    _put(sd, "encoder.stem", _conv(enc["Conv_0"]))
    _stages(sd, "encoder", enc, n_stages,
            lambda d, pre, i: _put(d, pre, _conv(enc[f"Conv_{i + 1}"])))
    _put(sd, "encoder.norm", _norm(enc, 0))
    _put(sd, "encoder.head", _dense(enc["gaussian_head"]))

    # decoder: ConvTranspose_i (conv_transpose) or Conv_i (nearest) upsample
    if _count(dec, "ConvTranspose"):
        n_stages = _count(dec, "ConvTranspose") + 1

        def up(d, pre, i):
            _put(d, pre, _conv_transpose(dec[f"ConvTranspose_{i}"]))
    else:
        n_stages = _count(dec, "Conv") + 1

        def up(d, pre, i):
            _put(d, f"{pre}.conv", _conv(dec[f"Conv_{i}"]))
    _put(sd, "decoder.dense", _dense(dec["Dense_0"]))
    _stages(sd, "decoder", dec, n_stages, up)
    _put(sd, "decoder.norm", _norm(dec, 0))
    _put(sd, "decoder.head", _conv(dec["likelihood_head"]))
    return sd


def _conv_vae(enc, dec) -> dict[str, torch.Tensor]:
    """Encoder ``Conv_0..`` (stride 2, stride 1 per width), ``Dense_0``,
    ``gaussian_head``; decoder ``Dense_0``, ``Dense_1``, ``Conv_0..`` (two
    per width), ``likelihood_head``. The Dense rows keep flax's (h, w, c)
    flatten order: the port's models flatten and reshape in that order."""
    sd: dict[str, torch.Tensor] = {}
    for i in range(_count(enc, "Conv")):
        _put(sd, f"encoder.convs.{i}", _conv(enc[f"Conv_{i}"]))
    _put(sd, "encoder.dense", _dense(enc["Dense_0"]))
    _put(sd, "encoder.head", _dense(enc["gaussian_head"]))
    _put(sd, "decoder.dense0", _dense(dec["Dense_0"]))
    _put(sd, "decoder.dense1", _dense(dec["Dense_1"]))
    for i in range(_count(dec, "Conv")):
        _put(sd, f"decoder.convs.{i}", _conv(dec[f"Conv_{i}"]))
    _put(sd, "decoder.head", _conv(dec["likelihood_head"]))
    return sd


def _latent_d(tree) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    cls = "SNDense" if "SNDense_0" in tree else "Dense"
    for i in range(_count(tree, cls)):
        _put(sd, f"layers.{i}", _dense(tree[f"{cls}_{i}"]))
    return sd


def _pixel_d(tree) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    for i in range(_count(tree, "Conv")):
        _put(sd, f"convs.{i}", _conv(tree[f"Conv_{i}"]))
    _put(sd, "head", _dense(tree["Dense_0"]))
    return sd


def d_params_from_flax(flax_d_params) -> dict[str, torch.Tensor]:
    """flax discriminator params -> the port's state dict: a
    ``LatentDiscriminator`` tree (``Dense_i``, or ``SNDense_i`` under
    spectral norm), or the biadversarial ``{"latent", "pixel"}`` pair,
    whose pixel tree (``Conv_i``, ``Dense_0``) maps to
    ``PixelDiscriminator``'s ``convs.i`` and ``head``."""
    if "latent" in flax_d_params:
        sd: dict[str, torch.Tensor] = {}
        _put(sd, "latent", _latent_d(flax_d_params["latent"]))
        _put(sd, "pixel", _pixel_d(flax_d_params["pixel"]))
        return sd
    return _latent_d(flax_d_params)


# ---------------------------------------------------------------------------
# a whole TrainState
# ---------------------------------------------------------------------------

def _get(node, key):
    """A child of a flax/optax state node: a dict key or list index (the
    orbax reader's trees), a NamedTuple or dataclass field, a tuple
    index."""
    if isinstance(node, dict) or isinstance(key, int):
        return node[key]
    return getattr(node, key)


def _has(node, key) -> bool:
    return key in node if isinstance(node, dict) else hasattr(node, key)


def _filled(tree) -> bool:
    """A params tree that holds parameters ({} and () hold none)."""
    return isinstance(tree, Mapping) and len(tree) > 0


def _ordered(sd: dict, module) -> list[torch.Tensor]:
    """A converted state dict as the list ``ClippedAdam`` keeps: the
    module's ``named_parameters()`` order."""
    names = [n for n, _ in module.named_parameters()]
    if set(names) != set(sd):
        raise ValueError("optimizer tree does not match the module's "
                         f"parameters: {sorted(set(names) ^ set(sd))[:6]}")
    return [sd[n] for n in names]


def adam_from_optax(opt_state, module, convert) -> dict:
    """An optax ``chain(clip_by_global_norm, adam)`` state, or its
    ``MultiSteps`` wrapper, -> ``ClippedAdam.state_dict()``'s format:
    adam's count, mu and nu (each moment tree through ``convert``, the
    parameters' own map, so ConvTranspose moments are flipped as the
    kernels are), and under ``MultiSteps`` ``mini_step`` and
    ``acc_grads`` as ``mini_step`` and ``acc``."""
    multi = _has(opt_state, "inner_opt_state")
    chain = _get(opt_state, "inner_opt_state") if multi else opt_state
    adam = _get(_get(chain, 1), 0)
    out = {"count": int(np.asarray(_get(adam, "count"))),
           "mu": _ordered(convert(_get(adam, "mu")), module),
           "nu": _ordered(convert(_get(adam, "nu")), module)}
    if multi:
        out.update(acc=_ordered(convert(_get(opt_state, "acc_grads")), module),
                   mini_step=int(np.asarray(_get(opt_state, "mini_step"))))
    return out


def train_state_from_flax(tree, state) -> dict:
    """A flax ``TrainState`` (the object, or the orbax reader's tree of its
    fields) -> ``TrainState.state_dict()``'s format for ``state``, the
    port's state of the same config, which gives the optimizers'
    parameter order and the seed (the run's ``train.seed``; the
    reference's threefry key is not carried: a resumed run draws Philox
    noise).

    ``params`` -> ``model``, ``d_params`` -> ``d`` (absent when empty),
    ``opt_state``/``d_opt_state`` -> ``opt``/``d_opt``; a non-empty
    ``ema_params`` -> ``ema_model``, so that a tree without a shadow, or
    with an empty one, seeds a wanted shadow from the parameters
    (``TrainState.load_state_dict``)."""
    out = {"step": int(np.asarray(_get(tree, "step"))), "seed": state.seed,
           "model": params_from_flax(_get(tree, "params")),
           "opt": adam_from_optax(_get(tree, "opt_state"), state.model,
                                  params_from_flax)}
    d_params = _get(tree, "d_params") if _has(tree, "d_params") else {}
    if _filled(d_params):
        if state.d is None:
            raise ValueError("the checkpoint holds a D and this config is "
                             "not adversarial")
        out.update(d=d_params_from_flax(d_params),
                   d_opt=adam_from_optax(_get(tree, "d_opt_state"), state.d,
                                         d_params_from_flax))
    ema = _get(tree, "ema_params") if _has(tree, "ema_params") else {}
    if _filled(ema):
        out["ema_model"] = params_from_flax(ema)
    return out
