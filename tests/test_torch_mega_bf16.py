"""The bf16 MEGA detector: the port against the JAX package on the CPU, both
on bf16 parameters (``cast_floating`` here, ``_cast_f32_leaves`` there) and
bf16 features, from the fused set-attention's plain version up to
``extract_video_features``.

Tolerances:
- ``KERNEL_TOL`` 1e-2 of 1 + max |want| for ``mega_attention_plain`` against
  the Pallas kernel in interpret mode on the same bf16 operands. Inside one
  128-key tile the two take the same arithmetic up to the order of fp32
  sums (fp32 scores, P rounded to bf16 against the row's max, l of the
  unrounded P, the output rounded once); over several tiles the Pallas
  kernel rounds each tile's P against a running max and rescales it later,
  a bf16 step at most.
- ``MAX_TOL`` 5e-2 and ``MEAN_TOL`` 5e-3 of max |ref| for the largest and
  the mean gap of the head, the stream, the backbone's C4, the fc0 of fixed
  rois and ``extract_video_features``: JAX's own limits for its bf16 path
  against fp32 (``tests/test_detector.py::test_bf16_precompute_parity``,
  ``test_bf16_stream_parity``). Each framework rounds to bf16 in its own
  places (a Dense's bias added after the product's rounding in JAX, fused
  into it in torch), so two bf16 runs differ by about what bf16 and fp32
  differ by. ``extract_video_features`` ends in the MEGA scan over random
  weights, whose saturated softmax turns any rounding into near-ties: on
  these inputs JAX's own bf16 result is 7.9e-2 of max |ref| from its fp32
  one at its largest gap (the port's bf16 7.5e-2 from JAX's fp32, the fp32
  runs within 5e-4 of each other, ``tests/test_torch_detector.py``). Two
  bf16 runs each that far from fp32 can be twice that far apart, so its
  largest gap is held to the larger of ``MAX_TOL`` and twice JAX's own
  bf16-to-fp32 gap on the same inputs, and the port's bf16 to the larger
  of ``MAX_TOL`` and that gap itself against JAX's fp32; its mean gap to
  ``MEAN_TOL``.
No NMS decision is in any compared loop (fixed rois, fixed fc0 inputs), as in
JAX's bf16 tests; whole videos through the RPN are checked for shapes, dtypes
and finite values only, as there. ``python -m tests.test_torch_mega_bf16``
prints every measured gap.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_detector import detectors, rand_boxes  # noqa: F401
from tests.test_torch_mega import (CPU, FD, G, as_sets,  # noqa: F401
                                   head_pair, rand_rois, randomize, t)
from tools.export_params_npz import flatten_params
from vrdone_tpu.models import detector as jd
from vrdone_tpu.models import mega as jm
from vrdone_tpu.ops.pallas import mega_attention as jma
from vrdone_tpu_torch.convert import load_params, params_to_jax
from vrdone_tpu_torch.models import detector as td
from vrdone_tpu_torch.models import mega as tm
from vrdone_tpu_torch.ops import mega_attention as tma
from vrdone_tpu_torch.utils.precision import cast_floating

torch.set_num_threads(1)

BF = torch.bfloat16
KERNEL_TOL = 1e-2
MAX_TOL, MEAN_TOL = 5e-2, 5e-3


def gap(got, want) -> tuple[float, float]:
    """Largest and mean |got - want| over max |want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    return (np.abs(got - want).max() / scale,
            np.abs(got - want).mean() / scale)


def gaps(got, want, name, max_tol=MAX_TOL) -> None:
    """``gap``, printed and held to ``max_tol`` and MEAN_TOL."""
    worst, mean = gap(got, want)
    print(f"{name}: largest gap {worst:.3e}, mean {mean:.3e} of max |ref| "
          f"(limits {max_tol:.3e}, {MEAN_TOL})")
    assert worst < max_tol and mean < MEAN_TOL, name


def jbf(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def tbf(x):
    return t(x).to(BF)


# -- the fused set-attention's plain version --------------------------------

@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("n,m,g,dg,dgo", [
    pytest.param(24, 100, 4, 32, 32, id="24-100"),    # one 128-key tile
    pytest.param(150, 300, 4, 32, 32, id="150-300"),  # 2 query blocks x 3 key tiles
    # the edges of the CUDA kernel's bf16 instance (16-row blocks, 16-key
    # tiles, channel buckets): a row and a key past a tile at 16 groups;
    # dg % 8 != 0 with a ragged dgo (2-byte copies, the 64 bucket); the
    # 256 bucket (4 groups a block)
    pytest.param(17, 33, 16, 64, 64, id="g16-17-33"),
    pytest.param(13, 77, 5, 30, 40, id="g5-13-77-dg30-dgo40"),
    pytest.param(10, 12, 4, 256, 256, id="g4-10-12-d256")])
def test_attention_plain_bf16_matches_pallas(with_bias, n, m, g, dg, dgo):
    """bf16 q, k and vproj with an fp32 ub (as the head makes it) through
    the plain version and through JAX's kernel in interpret mode at its
    bf16 blocks (128 x 128). The plain version is what the CUDA kernel is
    held to on the card, so these shapes carry that kernel's edges back to
    the Pallas kernel."""
    rng = np.random.default_rng(n + m)
    q, k, vp = (rng.standard_normal(s).astype(np.float32)
                for s in ((g, n, dg), (g, m, dg), (g, m, dgo)))
    ub = (0.3 * rng.standard_normal((g, m))).astype(np.float32)
    valid = rng.uniform(size=m) > 0.2
    extra = ()
    if with_bias:
        extra = (rand_rois(rng, n), rand_rois(rng, m),
                 (rng.standard_normal((64, g)) * 0.01).astype(np.float32),
                 np.full((g,), 0.1, np.float32))
    want = jma.fused_mega_attention(
        jbf(q), jbf(k), jbf(vp), jnp.asarray(ub), jnp.asarray(valid),
        *(jnp.asarray(a) for a in extra), interpret=True)
    got = tma.fused_mega_attention(tbf(q), tbf(k), tbf(vp), t(ub), t(valid),
                                   *(t(a) for a in extra))
    assert want.dtype == jnp.bfloat16 and got.dtype == BF
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    limit = KERNEL_TOL * (1 + np.abs(want).max())
    print(f"plain bf16 vs Pallas N={n} M={m} bias={with_bias}: max |err| "
          f"{err:.3e}, {err / (1 + np.abs(want).max()):.3e} of "
          f"1 + max |want| (limit {KERNEL_TOL})")
    assert err <= limit


def test_attention_plain_bf16_all_invalid_is_zero():
    rng = np.random.default_rng(3)
    q, k, vp = (tbf(rng.standard_normal((2, 5, 8)).astype(np.float32))
                for _ in range(3))
    out = tma.fused_mega_attention(q, k, vp, torch.zeros(2, 5),
                                   torch.zeros(5, dtype=torch.bool))
    assert out.dtype == BF and (out == 0).all()


# -- the head and the stream ------------------------------------------------

def bf16_sets(inputs, box_set, conv, cast):
    """The head's inputs with every feature in bf16 (the rois and masks as
    they are), as the bf16 stream hands them over."""
    key, key_rois, key_valid, win, mem, glob = as_sets(inputs, box_set, conv)
    feat = lambda s: s._replace(feat=cast(s.feat))  # noqa: E731
    return (cast(key), key_rois, key_valid, feat(win),
            [feat(s) for s in mem], feat(glob))


@pytest.mark.parametrize("route", ["dense", "fused_attention"])
def test_enhance_bf16_matches_jax(head_pair, route):
    """MEGAHead.enhance on bf16 parameters and features, memory and global
    on: the dense route (JAX promotes its attention to fp32, the port
    too) and the fused route (bf16 throughout; the plain version here, the
    Pallas kernel in interpret mode there)."""
    kw, params, ours, inputs = head_pair
    flags = dict(fused_pe_bias=False,
                 fused_attention=route == "fused_attention")
    head = jm.MEGAHead(**kw, **flags)
    p16 = jd._cast_f32_leaves(params, jnp.bfloat16)
    jargs = bf16_sets(inputs, jm.BoxSet, jnp.asarray,
                      lambda x: x.astype(jnp.bfloat16))
    want, want_push = jax.jit(lambda p, *a: head.apply(
        p, *a, return_pushes=True, method=jm.MEGAHead.enhance))(p16, *jargs)
    with torch.no_grad():
        got, got_push = cast_floating(ours).routed(**flags).enhance(
            *bf16_sets(inputs, tm.BoxSet, t, lambda x: x.to(BF)),
            return_pushes=True)
    want_dt = {"dense": torch.float32, "fused_attention": BF}[route]
    assert str(want.dtype) == str(want_dt).split(".")[1] and \
        got.dtype == want_dt
    gaps(got.float(), want, f"enhance bf16 {route}")
    for i, (a, b) in enumerate(zip(got_push, want_push)):
        gaps(a.feat.float(), b.feat, f"enhance bf16 {route} push {i}")
        np.testing.assert_array_equal(a.valid.numpy(), np.asarray(b.valid))


@pytest.mark.parametrize("route", ["dense", "fused_attention"])
def test_stream_video_bf16_matches_jax(route):
    """stream_video(compute_dtype="bfloat16") from fp32 parameters and fixed
    fc0 inputs (no RPN or NMS in the loop): both cast the head, the
    features and the memories to bf16 and return fp32."""
    rng = np.random.default_rng(12)
    kw = dict(feat_dim=FD, groups=G, stage=2, global_res_stage=1,
              advanced_num=2)
    flags = dict(fused_pe_bias=False,
                 fused_attention=route == "fused_attention")
    tt, nk, b = 6, 5, 4
    key = rng.standard_normal((tt, nk, FD)).astype(np.float32)
    key_rois = rand_rois(rng, tt * nk).reshape(tt, nk, 4)
    key_valid = rng.uniform(size=(tt, nk)) > 0.2
    ref = rng.standard_normal((tt, b, FD)).astype(np.float32)
    ref_rois = rand_rois(rng, tt * b).reshape(tt, b, 4)
    ref_valid = rng.uniform(size=(tt, b)) > 0.2
    gi = jm.global_indices(tt, 3, seed=2)
    head = jm.MEGAHead(**kw, **flags)
    win = jm.BoxSet(*(jnp.asarray(x[:2]) for x in (ref, ref_rois,
                                                   ref_valid)))
    mem = [jm.flatten_set(win)] * 2
    # (initialised on pooled keys, so that l_fc0 exists as in the port)
    shapes = jax.eval_shape(lambda r: head.init(
        r, jnp.asarray(key[0]), jnp.asarray(key_rois[0]),
        jnp.asarray(key_valid[0]), win, mem, jm.flatten_set(win),
        method=jm.MEGAHead.enhance), jax.random.key(0))["params"]
    params = randomize(shapes, 12)
    ours = tm.MEGAHead(**kw, **flags, in_dim=FD, device=CPU)
    load_params(ours, flatten_params(params))
    sched = dict(mem_size=3, window=3, key_loc=1, glob_idx=gi,
                 compute_dtype="bfloat16")
    want = np.asarray(jm.stream_video(
        head, {"params": params}, key_feat=jnp.asarray(key),
        key_rois=jnp.asarray(key_rois), key_valid=jnp.asarray(key_valid),
        key_is_fc0=True, ref_feat=jnp.asarray(ref),
        ref_rois=jnp.asarray(ref_rois), ref_valid=jnp.asarray(ref_valid),
        **sched))
    with torch.no_grad():
        got = tm.stream_video(
            ours, key_feat=t(key), key_rois=t(key_rois),
            key_valid=t(key_valid), key_is_fc0=True, ref_feat=t(ref),
            ref_rois=t(ref_rois), ref_valid=t(ref_valid), **sched)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert next(ours.parameters()).dtype == torch.float32  # left as it was
    gaps(got.numpy(), want, f"stream_video bf16 {route}")
    assert np.abs(got.numpy()[~key_valid]).max() == 0.0


def test_project_values_takes_the_values_dtype():
    """GroupedLinear.project_values casts its kernel to the values' dtype,
    as JAX's does (mega.py:458-463): an fp32 kernel on bf16 values is
    rounded, and the product is bf16 in both packages."""
    rng = np.random.default_rng(8)
    g, m, d = 4, 9, 32
    mod = jm.GroupedLinear(d, g)
    vals = rng.standard_normal((m, d)).astype(np.float32)
    shapes = jax.eval_shape(lambda r: mod.init(
        r, att=np.zeros((g, 2, m), np.float32), values=vals),
        jax.random.key(0))["params"]
    params = randomize(shapes, 8)
    ours = torch.nn.Module()
    ours.l_Wv0 = tm.GroupedLinear(d, g, device=CPU)
    load_params(ours, flatten_params({"l_Wv0": params}))
    lin = ours.l_Wv0
    want = mod.apply({"params": params}, jbf(vals),
                     method=jm.GroupedLinear.project_values)
    with torch.no_grad():
        got = lin.project_values(tbf(vals))
    assert want.dtype == jnp.bfloat16 and got.dtype == BF
    assert torch.equal(got, torch.einsum("md,gdo->gmo", tbf(vals),
                                         lin.kernel.to(BF)))
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    print(f"project_values bf16: max |err| {err:.3e} against JAX")
    assert err <= 2 ** -8 * np.abs(np.asarray(want, np.float32)).max()


# -- the detector -----------------------------------------------------------

def test_cast_floating_leaves_no_fp32_tensor(detectors):
    """The bf16 copy casts the same set JAX's _cast_f32_leaves casts: every
    parameter of the detector (FrozenBN's statistics among them; the
    detector has no other floating dtype and no buffer), and leaves the
    fp32 detector as it was."""
    det, params, ours, _ = detectors
    cast = cast_floating(ours)
    tensors = dict(cast.named_parameters())
    tensors.update(cast.named_buffers())
    floating = {k: v.dtype for k, v in tensors.items()
                if v.is_floating_point()}
    assert floating and set(floating.values()) == {BF}
    assert all(p.dtype == torch.float32 for p in ours.parameters())
    jcast = jax.tree_util.tree_leaves(
        jd._cast_f32_leaves(params, jnp.bfloat16))
    assert {x.dtype for x in jcast} == {jnp.dtype(jnp.bfloat16)}
    mine = params_to_jax({k: v.float() for k, v in cast.state_dict().items()})
    assert sorted(mine) == sorted(flatten_params(params["params"]))
    assert len(floating) == len(jcast)


def test_features_and_fc0_bf16_match_jax(detectors):
    """The bf16 backbone's C4 of two frames and the fc0 of fixed rois (no
    NMS decision in the loop), as tests/test_detector.py pins JAX's."""
    det, params, ours, images = detectors
    rois = np.asarray([[4.0, 4.0, 60.0, 50.0], [20.0, 10.0, 120.0, 90.0],
                       [0.0, 0.0, 127.0, 95.0]], np.float32)
    valid = np.asarray([True, True, False])

    def fwd(m, imgs):
        c4 = m.features(imgs, compute_dtype=jnp.bfloat16)
        return c4, m.frame_fc0(c4[0], jnp.asarray(rois), jnp.asarray(valid))

    want = jax.jit(lambda p, i: det.apply(p, i, method=fwd))(
        jd._cast_f32_leaves(params, jnp.bfloat16), jnp.asarray(images[:2]))
    cast = cast_floating(ours)
    with torch.no_grad():
        c4 = cast.features(t(images[:2]), BF)
        fc0 = cast.frame_fc0(c4[0], t(rois), t(valid))
    assert c4.dtype == fc0.dtype == BF and want[0].dtype == jnp.bfloat16
    gaps(c4.permute(0, 2, 3, 1).float(), want[0], "c4 bf16")
    gaps(fc0.float(), want[1], "fc0 bf16 of fixed rois")
    assert (fc0[~t(valid)] == 0).all()


def test_extract_video_features_bf16_matches_jax(detectors):
    """The whole bf16 path with no NMS in the loop: the backbone and RoI
    head on given boxes, then the MEGA scan on their fc0 features. The
    largest gaps' limits follow JAX's own bf16-to-fp32 gap here where that
    is more than MAX_TOL (the module's docstring)."""
    det, params, ours, images = detectors
    rng = np.random.default_rng(5)
    rois = np.stack([rand_boxes(rng, 5) for _ in range(images.shape[0])])
    valid = rng.uniform(size=rois.shape[:2]) > 0.3
    valid[:, 0] = True
    kw = dict(batch=3, compute_dtype="bfloat16")
    want = jd.extract_video_features(det, params, images, rois, valid, **kw)
    fp32 = jd.extract_video_features(det, params, images, rois, valid,
                                     batch=3)
    got = td.extract_video_features(ours, images, rois, valid, **kw)
    assert got.dtype == want.dtype == np.float32
    own = gap(want, fp32)[0]
    print(f"extract_video_features: JAX's bf16 against its fp32, largest "
          f"gap {own:.3e} of max |ref|")
    gaps(got, fp32, "extract_video_features bf16 against JAX's fp32",
         max(MAX_TOL, own))
    gaps(got, want, "extract_video_features bf16", max(MAX_TOL, 2 * own))
    assert np.abs(got[~valid]).max() == 0.0


@pytest.mark.parametrize("fused_attention", [False, True])
def test_detect_video_bf16_runs(detectors, fused_attention):
    """detect_video in bf16 through both attention routes: shapes and
    dtypes of the fp32 run, finite values (random weights put NMS near-ties
    in the loop, so whole videos are compared by neither JAX's tests nor
    these). The detector's parameters stay fp32."""
    _, _, ours, images = detectors
    hw = np.asarray(images.shape[1:3], np.float32)
    kw = dict(key_post_nms=8, fused_attention=fused_attention)
    ref = td.detect_video(ours, images, hw, **kw)
    got = td.detect_video(ours, images, hw, compute_dtype="bfloat16", **kw)
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k
        assert np.isfinite(v).all() if v.dtype != bool else True, k
    assert got["visual"].dtype == np.float32 and got["valid"].any()
    assert all(p.dtype == torch.float32 for p in ours.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        td.detect_video(ours, images, hw, compute_dtype="float16", **kw)


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-q", "-s",
                                  "-p", "no:cacheprovider"]))
