"""The port's whole MaskVRD eval forward against the JAX package's on the
same converted parameters, the converter's strictness, and that the port
runs without JAX.

Tolerance 5e-4 for the whole model, the value tests/test_model_parity.py
uses against the torch reference: fp32 sums taken in another order drift
through some forty chained layers.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_model_parity import packed_channels, small_cfg
from tests.test_torch_layers import randomize
from tools.export_params_npz import flatten_params
from vrdone_tpu.models.maskvrd import MaskVRD as JaxMaskVRD
from vrdone_tpu_torch import config as tconfig
from vrdone_tpu_torch.convert import load_npz, load_params, params_from_jax
from vrdone_tpu_torch.models.maskvrd import MaskVRD

torch.set_num_threads(1)

TOL = 5e-4
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_config(cfg) -> tconfig.ModelConfig:
    """The same configuration in the port's mirrored dataclasses."""
    d = dataclasses.asdict(cfg)
    d["predictor"] = tconfig.PredictorConfig(**d["predictor"])
    return tconfig.ModelConfig(**d)


def jax_model_and_params(cfg, seed=0):
    jm = JaxMaskVRD(cfg)
    t = cfg.max_seq_len
    x = jnp.zeros((2, t, packed_channels(cfg)))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed), x,
                            jnp.ones((2, t), bool))["params"]
    return jm, randomize(shapes, seed)


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b, t = 3, cfg.max_seq_len
    x = rng.standard_normal((b, t, packed_channels(cfg))).astype(np.float32)
    mask = np.arange(t)[None] < np.array([t, t // 2, 11])[:, None]
    return x * mask[..., None], mask


@pytest.mark.parametrize("use_local,use_abs_pe", [(False, False),
                                                  (True, False),
                                                  (False, True)])
def test_forward_matches_jax(use_local, use_abs_pe):
    cfg = small_cfg(use_local=use_local, use_abs_pe=use_abs_pe)
    jm, params = jax_model_and_params(cfg)
    tm = MaskVRD(port_config(cfg), device=CPU)
    load_params(tm, flatten_params(params))
    x, mask = inputs(cfg)
    pj = jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                           jnp.asarray(mask))
    with torch.no_grad():
        pt = tm(torch.from_numpy(x), torch.from_numpy(mask))
    for key in ("pred_logits", "pred_masks"):
        np.testing.assert_allclose(pt[key].numpy(), np.asarray(pj[key]),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(pt["output_mask"].numpy(),
                                  np.asarray(pj["output_mask"]))
    assert len(pt["aux_outputs"]) == len(pj["aux_outputs"]) == 2
    for at, aj in zip(pt["aux_outputs"], pj["aux_outputs"]):
        for key in ("pred_logits", "pred_masks"):
            np.testing.assert_allclose(at[key].numpy(), np.asarray(aj[key]),
                                       atol=TOL, rtol=TOL)


def test_converter_is_strict_and_npz_round_trips(tmp_path):
    cfg = small_cfg()
    _, params = jax_model_and_params(cfg, seed=1)
    flat = flatten_params(params)
    path = tmp_path / "params.npz"
    np.savez(path, **flat)
    loaded = load_npz(str(path))
    assert loaded.keys() == flat.keys()
    tm = MaskVRD(port_config(cfg), device=CPU)
    load_params(tm, loaded)
    # layouts: Dense (in, out) -> (out, in); conv (K, Cin/g, Cout) -> (Cout, Cin/g, K)
    sd = params_from_jax(flat)
    k = "backbone/stem_0/attn/query/kernel"
    np.testing.assert_array_equal(
        sd["backbone.stem_0.attn.query.weight"].numpy(), flat[k].T)
    k = "backbone/visual_embd_0/kernel"
    np.testing.assert_array_equal(
        sd["backbone.visual_embd_0.weight"].numpy(),
        flat[k].transpose(2, 1, 0))
    missing = dict(flat)
    missing.pop("predictor/query_embed")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_params(tm, missing)
    extra = dict(flat, **{"predictor/extra/kernel": np.zeros((2, 2))})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_params(tm, extra)
    wrong = dict(flat, **{"predictor/query_embed": np.zeros((2, 2))})
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_params(tm, wrong)


def test_random_init_is_seeded_and_finite():
    cfg = port_config(small_cfg())
    a = MaskVRD(cfg, device=CPU, generator=torch.Generator().manual_seed(3))
    b = MaskVRD(cfg, device=CPU, generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    x, mask = inputs(small_cfg())
    with torch.no_grad():
        out = a(torch.from_numpy(x), torch.from_numpy(mask))
    assert torch.isfinite(out["pred_logits"]).all()
    assert torch.isfinite(out["pred_masks"]).all()


def test_port_runs_without_jax():
    """Importing the port and running a CPU forward leaves JAX, flax and
    the JAX package out of sys.modules."""
    code = (
        "import sys, torch\n"
        "from vrdone_tpu_torch.config import ModelConfig, PredictorConfig\n"
        "from vrdone_tpu_torch.models.maskvrd import MaskVRD\n"
        "from vrdone_tpu_torch.eval.decode import InferenceRunner\n"
        "from vrdone_tpu_torch import convert\n"
        "cfg = ModelConfig(visual_dim=8, embd_dim=16, fpn_dim=8, "
        "max_seq_len=48, predictor=PredictorConfig(n_input=16, n_embd=8, "
        "n_hidden=16, num_layers=2))\n"
        "m = MaskVRD(cfg, device=torch.device('cpu'), "
        "generator=torch.Generator().manual_seed(0))\n"
        "x = torch.randn(2, 48, 2 * 8 + 5 + 16)\n"
        "out = m(x, torch.ones(2, 48, dtype=torch.bool))\n"
        "assert torch.isfinite(out['pred_masks']).all()\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'vrdone_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
