"""The port's layers against the flax layers of ``vrdone_tpu.models.layers``
on the same converted parameters.

The flax parameter shapes are traced, then every leaf is drawn from numpy
(so the 1e-4 AffineDropPath scales and zero biases of the real init do not
hide a branch), flattened to ``/`` keys, converted and loaded into the port
with ``vrdone_tpu_torch.convert.load_params``. Tolerance 1e-4 (fp32): the
frameworks sum in different orders, and a block chains several such sums.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tools.export_params_npz import flatten_params
from vrdone_tpu.models import layers as jl
from vrdone_tpu_torch.convert import load_params
from vrdone_tpu_torch.models import layers as tl

torch.set_num_threads(1)

TOL = 1e-4
CPU = torch.device("cpu")


def randomize(params, seed):
    """Draw every flax leaf (arrays or shape structs) from numpy: kernels
    with variance 1/fan_in, LayerNorm weights and drop-path scales near 1,
    biases small, the rest N(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = path[-1].key
        shape = x.shape
        if name == "kernel" or name.endswith("_kernel"):
            bound = np.sqrt(3.0 / np.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if name in ("weight", "scale"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def jax_and_torch(jax_module, torch_module, *inputs, seed=0):
    """Trace ``jax_module``'s init on ``inputs``, draw its params, load them
    into ``torch_module``. Returns the flax params (for ``apply``)."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(seed),
                            *(jnp.asarray(a) for a in inputs))["params"]
    params = randomize(shapes, seed)
    load_params(torch_module, flatten_params(params))
    return {"params": params}


def close(ours, theirs, tol=TOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               atol=tol, rtol=tol)


def seq(rng, b, t, c, lens):
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    mask = np.arange(t)[None] < np.asarray(lens)[:, None]
    return x, mask


@pytest.mark.parametrize("strides,win", [((1, 1), 7), ((2, 2), 7),
                                         ((1, 1), -1), ((2, 2), 9)])
def test_transformer_block(strides, win):
    rng = np.random.default_rng(0)
    c, h = 32, 4
    x, mask = seq(rng, 3, 24, c, [24, 11, 5])
    jm = jl.TransformerBlock(c, h, n_ds_strides=strides, path_pdrop=0.1,
                             mha_win_size=win)
    tm = tl.TransformerBlock(c, h, n_ds_strides=strides, path_pdrop=0.1,
                             mha_win_size=win, device=CPU)
    params = jax_and_torch(jm, tm, x, mask)
    jo, jmask = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(mask))
    to, tmask = tm(torch.from_numpy(x), torch.from_numpy(mask))
    close(to, jo)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("qx,kv,qkv_api", [(1, 1, False), (0, 1, True),
                                           (2, 2, False)])
def test_local_conv_mha_and_conv_mha(qx, kv, qkv_api):
    rng = np.random.default_rng(1)
    c, h = 32, 4
    x, mask = seq(rng, 2, 20, c, [20, 9])
    y, _ = seq(rng, 2, 20, c, [20, 9])
    for jm, tm in [
            (jl.LocalConvMHA(c, h, window_size=7, n_qx_stride=qx,
                             n_kv_stride=kv, qkv_api=qkv_api),
             tl.LocalConvMHA(c, h, window_size=7, n_qx_stride=qx,
                             n_kv_stride=kv, qkv_api=qkv_api, device=CPU)),
            (jl.ConvMHA(c, h, n_qx_stride=qx, n_kv_stride=kv,
                        qkv_api=qkv_api),
             tl.ConvMHA(c, h, n_qx_stride=qx, n_kv_stride=kv,
                        qkv_api=qkv_api, device=CPU))]:
        inputs = (x, y, y, mask, mask)
        params = jax_and_torch(jm, tm, *inputs)
        jo, jmask = jax.jit(jm.apply)(params, *(jnp.asarray(a) for a in inputs))
        to, tmask = tm(*(torch.from_numpy(a) for a in inputs))
        close(to, jo)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("use_local,with_ffn,qx", [(False, True, 0),
                                                   (True, True, 0),
                                                   (False, False, 1),
                                                   (True, False, 1)])
def test_decoder_layer(use_local, with_ffn, qx):
    """The predictor's flavour (9 queries against a shorter memory, MHA
    self-attention) and the backbone's (ConvMHA both ways, no FFN)."""
    rng = np.random.default_rng(2)
    c, h = 16, 4
    if qx == 0:
        tgt, tgt_mask = seq(rng, 2, 9, c, [9, 9])
        query_pos, _ = seq(rng, 2, 9, c, [9, 9])
    else:
        tgt, tgt_mask = seq(rng, 2, 12, c, [12, 7])
        query_pos = None
    mem, mem_mask = seq(rng, 2, 12, c, [12, 7])
    kw = dict(path_pdrop=0.1, n_qx_stride=qx, n_kv_stride=1,
              with_ffn=with_ffn, use_local=use_local,
              win_size=7 if use_local else None)
    jm = jl.DecoderLayer(c, h, **kw)
    tm = tl.DecoderLayer(c, h, **kw, device=CPU)
    inputs = (tgt, mem, tgt_mask, mem_mask)
    if use_local and qx == 0:
        # local self-attention over 9 queries needs Tq == Tk: the memory is
        # the query sequence itself here
        inputs = (tgt, tgt, tgt_mask, tgt_mask)
    qp = None if query_pos is None else jnp.asarray(query_pos)
    shapes = jax.eval_shape(
        lambda *a: jm.init(jax.random.PRNGKey(0), *a, query_pos=qp),
        *(jnp.asarray(a) for a in inputs))["params"]
    params = {"params": randomize(shapes, 3)}
    load_params(tm, flatten_params(params["params"]))
    jo, jmask = jax.jit(jm.apply)(params, *(jnp.asarray(a) for a in inputs),
                         query_pos=qp)
    to, tmask = tm(*(torch.from_numpy(a) for a in inputs),
                   query_pos=None if query_pos is None
                   else torch.from_numpy(query_pos))
    close(to, jo)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("kernel_size", [1, 3])
def test_conv_mlp(kernel_size):
    rng = np.random.default_rng(4)
    x, _ = seq(rng, 2, 10, 12, [10, 10])
    jm = jl.ConvMLP(16, 8, num_layers=3, kernel_size=kernel_size)
    tm = tl.ConvMLP(12, 16, 8, num_layers=3, kernel_size=kernel_size,
                    device=CPU)
    params = jax_and_torch(jm, tm, x)
    close(tm(torch.from_numpy(x)), jax.jit(jm.apply)(params, jnp.asarray(x)))


def test_rel_pe_is_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.LocalConvMHA(16, 4, window_size=7, use_rel_pe=True, device=CPU)
