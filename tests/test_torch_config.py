"""The port's package rules: its own copy of the presets stays equal to
``apv_tpu``'s, it imports nothing of JAX or ``apv_tpu``, and its entry
points run on the card unless the caller names the CPU."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from apv_tpu.utils import config as jcfg
from apv_tpu_torch.utils import config as tcfg

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "apv_tpu"}


def _shared(port: dict, ref: dict) -> dict:
    """The port's config tree cut to the reference's fields, after holding
    the port's own fields (the vdvae family's and Adam's second-moment decay)
    at their defaults: a reference preset behaves alike on both sides."""
    out = {}
    for key, value in port.items():
        if key not in ref:
            section = {"enc_blocks", "dec_blocks", "bottleneck_multiple",
                       "adam_b2"}
            assert key in section, key
            defaults = {**dataclasses.asdict(tcfg.ModelConfig()),
                        **dataclasses.asdict(tcfg.TrainConfig())}
            assert value == defaults[key], (key, value)
            continue
        out[key] = (_shared(value, ref[key]) if isinstance(value, dict)
                    else value)
    return out


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_equal(name):
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    j = dataclasses.asdict(jcfg.get_preset(name))
    assert _shared(dataclasses.asdict(tcfg.get_preset(name)), j) == j


def test_overrides_and_json_round_trip_equal():
    overrides = ["model.z_dim=8", "model.widths=[8,16]", "eval.iwae_k=20",
                 "adversarial.enabled=false", "train.lr=3e-4",
                 "eval.max_examples=32"]
    t = tcfg.apply_overrides(tcfg.get_preset("iwae_eval"), overrides)
    j = jcfg.apply_overrides(jcfg.get_preset("iwae_eval"), overrides)
    jd = dataclasses.asdict(j)
    assert _shared(dataclasses.asdict(t), jd) == jd
    import json
    assert _shared(json.loads(t.to_json()), jd) == json.loads(j.to_json())
    assert dataclasses.asdict(tcfg.config_from_dict(json.loads(j.to_json()))) \
        == dataclasses.asdict(t)


def _port_files():
    return sorted((ROOT / "apv_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_flax_or_apv_tpu():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert len(_port_files()) > 15


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from apv_tpu_torch import (build_model, evaluate_nll, make_latent_d,
                               make_scorer, make_train_fns, train_loop)
    from apv_tpu_torch.eval.iwae_eval import estimate_log_partition
    cfg = tcfg.apply_overrides(tcfg.get_preset("iwae_eval"), [
        "model.z_dim=8", "model.widths=[8,16]", "model.blocks_per_stage=1"])
    model = build_model(cfg.model, device="cpu")
    x_u8 = np.zeros((2, 32, 32, 3), np.uint8)
    calls = [
        lambda: build_model(cfg.model),
        lambda: make_latent_d(cfg.adversarial, 8),
        lambda: make_scorer(cfg, model),
        lambda: evaluate_nll(cfg, model, None, x_u8,
                             use_adversarial_prior=False),
        lambda: estimate_log_partition(lambda z: z[:, 0], 8),
        lambda: make_train_fns(cfg),
        lambda: train_loop(cfg, arrays={"image": x_u8}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="none is available"):
            call()


def test_ops_module_imports_without_cuda_or_nvcc():
    """Importing the kernel wrappers builds nothing; the build directory is
    only touched when a CUDA tensor reaches a kernel."""
    from apv_tpu_torch.ops import _build, kernels
    assert _build.build_seconds is None
    assert set(kernels.launches) == {"reparam", "kl", "disc_logistic",
                                     "bernoulli", "reparam_bwd", "kl_bwd",
                                     "bernoulli_bwd", "disc_logistic_bwd",
                                     "groupnorm_gelu", "groupnorm_gelu_bwd",
                                     "conv3x3", "rmsnorm_act",
                                     "rmsnorm_act_bwd"}
