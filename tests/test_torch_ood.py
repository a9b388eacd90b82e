"""Config 5 in the port against ``apv_tpu``: the OOD metrics and score
assembly, the PNG codelength, the sample-quality feature net and
distances, and the ``sample``/``ood_score`` entry points end to end on a
tiny checkpoint trained by the port.

The OOD assembly is compared with both sides' ``_per_sample`` (the IWAE
scoring, tested in ``test_torch_scoring``) stubbed to the same arrays, so
the comparison is of what ``ood_scores``/``ood_both`` build from them.
"""

import ast
import contextlib
import hashlib
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score

from apv_tpu.eval import ood as jood
from apv_tpu.eval import sample_quality as jsq
from apv_tpu.utils import config as jcfg
from apv_tpu_torch.eval import ood as tood
from apv_tpu_torch.eval import sample_quality as tsq
from apv_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
N_ROWS = 40


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("tied", [False, True])
def test_auroc_and_fpr_match_sklearn_and_apv_tpu(rng, tied):
    """auroc: sklearn's roc_auc_score and apv_tpu's within 1e-12;
    fpr_at_tpr: exactly apv_tpu's."""
    if tied:
        a = rng.integers(0, 6, 300).astype(np.float64)
        b = rng.integers(1, 7, 250).astype(np.float64)
    else:
        a = rng.normal(0.4, 1.0, 300)
        b = rng.normal(0.0, 1.0, 250)
    y = np.concatenate([np.ones_like(a), np.zeros_like(b)])
    want = roc_auc_score(y, np.concatenate([a, b]))
    assert abs(tood.auroc(a, b) - want) <= 1e-12
    assert abs(tood.auroc(a, b) - jood.auroc(a, b)) <= 1e-12
    assert abs(tood.auroc(-a, -b) - jood.auroc(-a, -b)) <= 1e-12
    for tpr in (0.95, 0.5, 0.99):
        assert tood.fpr_at_tpr(a, b, tpr) == jood.fpr_at_tpr(a, b, tpr)


def _cfgs(preset, *extra):
    over = ["data.synthetic_size=64", f"ood.max_examples={N_ROWS}",
            "ood.iwae_k=10", "ood.iwae_chunk=5", "ood.batch_size=8", *extra]
    return (jcfg.apply_overrides(jcfg.get_preset(preset), over),
            tcfg.apply_overrides(tcfg.get_preset(preset), over))


@pytest.mark.parametrize("preset,dataset", [("ood_suite", "cifar10"),
                                            ("ood_suite", "svhn"),
                                            ("mnist_vae", "mnist")])
def test_complexity_nats_matches_pillows(preset, dataset):
    """The port's PNG codelength against apv_tpu's (Pillow, optimize=True):
    within 1% per image, and in fact byte for byte (max relative
    difference 0 here)."""
    jc, tc = _cfgs(preset)
    want = jood.complexity_nats(jc, dataset)
    got = tood.complexity_nats(tc, dataset)
    assert got.shape == want.shape == (N_ROWS,)
    rel = np.abs(got - want) / want
    assert rel.max() <= 0.01
    np.testing.assert_array_equal(got, want)


def _stub_scores(params, dataset, use_adv, k):
    """Deterministic per-sample scores for (model, dataset, prior, k)."""
    tag = f"{params}/{dataset}/{bool(use_adv)}/{k}".encode()
    seed = int.from_bytes(hashlib.blake2s(tag, digest_size=4).digest(), "big")
    r = np.random.default_rng(seed)
    shift = {"cifar10": 0.0, "svhn": -0.7, "mnist": 0.2}.get(dataset, 0.0)
    return r.normal(-3000.0 + 40.0 * shift, 30.0, N_ROWS) + 5.0 * use_adv


@pytest.fixture
def stubbed(monkeypatch):
    def jax_side(cfg, params, d_params, dataset, *, use_adv, k, mesh, seed):
        return _stub_scores(params, dataset, use_adv, k)

    def port_side(cfg, model, d, dataset, *, use_adv, k, seed, device):
        return _stub_scores(model, dataset, use_adv, k)

    monkeypatch.setattr(jood, "_per_sample", jax_side)
    monkeypatch.setattr(tood, "_per_sample", port_side)


def _same(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            _same(g, w)
        elif isinstance(w, float):
            assert abs(g - w) <= 1e-6 * max(1.0, abs(w)), key
        else:
            assert g == w, key


@pytest.mark.parametrize("score", ["prior_ratio", "iwae", "elbo",
                                   "complexity", "model_ratio"])
def test_ood_assembly_matches_apv_tpu(stubbed, score):
    """ood_scores and ood_both (shared model) build apv_tpu's dicts from
    the same per-sample scores, within 1e-6."""
    jc, tc = _cfgs("ood_suite", f"ood.score={score}")
    base_j = base_t = None
    if score == "model_ratio":
        bj, bt = _cfgs("mnist_vae")
        base_j, base_t = (bj, "model_b", None), (bt, "model_b", None)
    want = jood.ood_scores(jc, "model_a", "d", baseline=base_j)
    got = tood.ood_scores(tc, "model_a", "d", baseline=base_t)
    _same(got, want)
    _same(tood.ood_both(tc, "model_a", "d", baseline=base_t),
          jood.ood_both(jc, "model_a", "d", baseline=base_j))


@pytest.mark.parametrize("score", ["model_ratio", "prior_ratio"])
def test_ood_both_with_reverse_model(stubbed, score):
    """With a reverse model: its own direction, and for model_ratio the
    roles swapped (the forward model becomes the reverse denominator)."""
    jc, tc = _cfgs("ood_suite", f"ood.score={score}")
    rj, rt = _cfgs("ood_suite", "name=svhn_run")
    base_j = base_t = None
    if score == "model_ratio":
        bj, bt = _cfgs("mnist_vae")
        base_j, base_t = (bj, "model_b", None), (bt, "model_b", None)
    want = jood.ood_both(jc, "model_a", "d", baseline=base_j,
                         reverse=(rj, "model_r", "d_r"))
    got = tood.ood_both(tc, "model_a", "d", baseline=base_t,
                        reverse=(rt, "model_r", "d_r"))
    _same(got, want)
    assert got["reverse_model"] == "own"


def test_ood_refusals(stubbed):
    _, tc = _cfgs("ood_suite", "ood.score=nll")
    with pytest.raises(ValueError, match="unknown ood.score"):
        tood.ood_scores(tc, "m", "d")
    _, tc = _cfgs("ood_suite", "ood.score=pixel_d")
    with pytest.raises(NotImplementedError, match="queue A item 12"):
        tood.ood_scores(tc, "m", "d")
    _, tc = _cfgs("ood_suite", "ood.score=model_ratio")
    with pytest.raises(ValueError, match="baseline"):
        tood.ood_scores(tc, "m", "d")
    _, tc = _cfgs("ood_suite")
    with pytest.raises(ValueError, match="adversarial checkpoint"):
        tood.ood_scores(tc, "m", None)


def test_shipped_feature_kernels_are_apv_tpus():
    """feature_params.npz holds apv_tpu's feature_seed=0 kernels exactly."""
    for c in (1, 3):
        want = jsq.feature_params(jax.random.PRNGKey(0), c)
        got = tsq.feature_params(c)
        assert len(got) == len(want) == 3
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="feature_seed"):
        tsq.feature_params(3, feature_seed=1)
    with pytest.raises(ValueError, match="c_in"):
        tsq.feature_params(2)


@pytest.mark.parametrize("shape", [(6, 32, 32, 3), (6, 28, 28, 1)])
def test_feature_net_matches_extract_features(rng, shape):
    """Features of the same images within 1e-4 of the largest."""
    x = rng.random(shape).astype(np.float32)
    c = shape[-1]
    want = jsq.extract_features(jsq.feature_params(jax.random.PRNGKey(0), c),
                                jnp.asarray(x))
    got = tsq.extract_features(tsq.feature_params(c), torch.from_numpy(x))
    assert got.shape == (shape[0], 256)
    assert _rel(got.numpy(), want) <= 1e-4


def test_distances_match_on_the_same_features(rng):
    """Fréchet, MMD² and density/coverage within 1e-6 relative."""
    fa = rng.normal(size=(60, 12))
    fb = rng.normal(0.3, 1.2, size=(50, 12))
    assert _rel(tsq.frechet_distance(fa, fb),
                jsq.frechet_distance(fa, fb)) <= 1e-6
    assert _rel(tsq.mmd2_rbf(fa, fb), jsq.mmd2_rbf(fa, fb)) <= 1e-6
    assert _rel(tsq.mmd2_rbf(fa, fb, 2.0), jsq.mmd2_rbf(fa, fb, 2.0)) <= 1e-6
    for k in (3, 5):
        got = tsq.density_coverage(fa, fb, k)
        want = jsq.density_coverage(fa, fb, k)
        assert _rel(got, want) <= 1e-6
    with pytest.raises(ValueError, match="needs > k"):
        tsq.density_coverage(fa[:5], fb, 5)


TINY = ["model.z_dim=8", "model.widths=[8,16]", "model.blocks_per_stage=1",
        "adversarial.d_widths=[32,32]", "train.batch_size=16",
        "train.steps=4", "train.steps_per_call=1", "train.eval_every=0",
        "train.checkpoint_every=4", "data.synthetic_size=96"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny cifar_advprior_resnet checkpoint written by the port."""
    from apv_tpu_torch import train_loop
    tmp = str(tmp_path_factory.mktemp("port_run"))
    cfg = tcfg.apply_overrides(tcfg.get_preset("cifar_advprior_resnet"),
                               TINY + [f"results_dir={tmp}"])
    with contextlib.redirect_stdout(io.StringIO()):
        train_loop(cfg, device="cpu")
    return tmp


def test_api_sample_end_to_end(trained):
    """sample() adopts the checkpoint's saved architecture, draws by SIR +
    MALA, writes the grid and sample_quality.json; the ex-post priors."""
    import json

    from apv_tpu_torch import sample
    from apv_tpu_torch.utils.png import decode_png
    from apv_tpu_torch.sampling.run import image_grid
    over = [f"results_dir={trained}"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        images = sample("cifar_advprior_resnet", overrides=over, n=12,
                        refine=2, quality_n=10, device="cpu")
    assert images.shape == (12, 32, 32, 3)
    assert float(images.min()) >= 0.0 and float(images.max()) <= 1.0
    run = Path(trained) / "cifar_advprior_resnet"
    assert np.array_equal(decode_png((run / "samples.png").read_bytes()),
                          image_grid(images))
    diag = json.loads(out.getvalue().splitlines()[0])["sampler_diagnostics"]
    assert 1.0 <= diag["sir_ess"] <= 12 * 16 and diag["mala_steps"] == 2
    quality = json.loads((run / "sample_quality.json").read_text())
    assert quality["n"] == 10 and np.isfinite(quality["frechet_rfd"])
    for prior in ("expost", "expost_gmm", "standard"):
        with contextlib.redirect_stdout(io.StringIO()):
            imgs = sample("cifar_advprior_resnet", overrides=over, n=6,
                          prior=prior, gmm_k=2, device="cpu")
        assert imgs.shape == (6, 32, 32, 3)
        assert (run / f"samples_{prior}.png").exists()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        imgs = sample("cifar_advprior_resnet", overrides=over, n=6,
                      prior="expost_flow", flow_steps=5, device="cpu")
    assert imgs.shape == (6, 32, 32, 3)
    assert (run / "samples_expost_flow.png").exists()
    assert np.isfinite(json.loads(out.getvalue())["expost_flow_fit_nll"])
    with pytest.raises(ValueError, match="temperature"):
        sample("cifar_advprior_resnet", overrides=over, n=2,
               temperature=0.7, device="cpu")
    with pytest.raises(ValueError, match="unknown prior"):
        sample("cifar_advprior_resnet", overrides=over, prior="flow",
               device="cpu")


def test_api_ood_score_end_to_end(trained):
    """ood_score() on ood_suite (its checkpoint_of run), both directions,
    then the complexity score; ood.json written."""
    import json

    from apv_tpu_torch import ood_score
    over = [f"results_dir={trained}", "ood.max_examples=24",
            "ood.iwae_k=4", "ood.iwae_chunk=2", "ood.batch_size=8"]
    res = ood_score("ood_suite", overrides=over, both=True, device="cpu")
    for r in (res["forward"], res["reverse"]):
        assert 0.0 <= r["auroc_in_vs_ood"] <= 1.0 and r["n_in"] == 24
        assert np.isfinite(r["in_mean"]) and np.isfinite(r["ood_mean"])
    assert res["forward"]["in_dataset"] == res["reverse"]["ood_dataset"]
    saved = json.loads((Path(trained) / "ood_suite" / "ood.json")
                       .read_text())
    assert saved == json.loads(json.dumps(res))
    c = ood_score("ood_suite", overrides=over + ["ood.score=complexity"],
                  device="cpu")
    assert c["score"] == "complexity" and np.isfinite(c["in_mean"])


def test_make_sampler_and_its_refusals(trained):
    from apv_tpu_torch import make_sampler
    from apv_tpu_torch.api import _adopt_checkpoint_arch, _resolve
    from apv_tpu_torch.api import _restore_state
    over = [f"results_dir={trained}", "eval.batch_size=5"]
    cfg = _adopt_checkpoint_arch(_resolve("cifar_advprior_resnet", over),
                                 over)
    state = _restore_state(cfg, device="cpu")
    fn = make_sampler(cfg, state.model, state.d, refine_steps=1,
                      device="cpu")
    a, b = fn(3), fn(3)
    assert a.shape == (5, 32, 32, 3) and torch.equal(a, b)
    pm = (torch.zeros(8), torch.ones(8))
    assert make_sampler(cfg, state.model, None, prior_moments=pm,
                        device="cpu")(0).shape == (5, 32, 32, 3)
    with pytest.raises(ValueError, match="refine_steps"):
        make_sampler(cfg, state.model, None, refine_steps=2, device="cpu")
    with pytest.raises(ValueError, match="refine_steps"):
        make_sampler(cfg, state.model, state.d, refine_steps=2,
                     prior_moments=pm, device="cpu")
    flow = tcfg.apply_overrides(cfg, ["model.prior=flow",
                                      "adversarial.enabled=false"])
    from apv_tpu_torch.models import build_model
    flow_model = build_model(flow.model, device="cpu")
    a = make_sampler(flow, flow_model, None, temperature=0.7,
                     device="cpu")(1)
    assert a.shape == (5, 32, 32, 3) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="temperature"):
        make_sampler(cfg, state.model, state.d, temperature=0.7,
                     device="cpu")


def test_config5_entry_points_need_the_card_by_default(trained):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from apv_tpu_torch import make_sampler, ood_score, sample
    over = [f"results_dir={trained}"]
    cfg = tcfg.apply_overrides(tcfg.get_preset("cifar_advprior_resnet"),
                               TINY)
    for call in (lambda: sample("cifar_advprior_resnet", overrides=over),
                 lambda: ood_score("ood_suite", overrides=over),
                 lambda: make_sampler(cfg, torch.nn.Linear(1, 1))):
        with pytest.raises(RuntimeError, match="none is available"):
            call()


def test_port_imports_no_sklearn_pil_matplotlib_jax_or_apv_tpu():
    """Every module of apv_tpu_torch: no import of sklearn, PIL,
    matplotlib, jax or apv_tpu (the card's machine has neither sklearn
    nor Pillow)."""
    forbidden = {"sklearn", "PIL", "matplotlib", "jax", "jaxlib", "flax",
                 "optax", "apv_tpu"}
    files = sorted((ROOT / "apv_tpu_torch").rglob("*.py"))
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in forbidden]
    assert not bad, bad
    assert any(p.name == "ood.py" for p in files)
