"""MEGA relation-attention head and its streaming driver (counterpart of
``vrdone_tpu/models/mega.py``).

Every proposal set is padded to a fixed size with a validity mask; the
per-stage long-range memories are fixed-size ring buffers; a video is a
Python loop over key frames (the JAX package's ``lax.scan``) after a batched
precompute of the per-frame fc0-level features. The attention takes one of
three routes, with the same parameters: dense, dense with the geometric bias
from the position-bias kernel (``fused_pe_bias``), or the fused set-attention
kernel (``fused_attention``, which supersedes the other). On CPU tensors both
kernels take their plain versions.

A bf16 head (a ``cast_floating`` copy) computes with JAX's promotions: a
layer or product of a bf16 and an fp32 operand runs in fp32 (torch refuses
mixed operands where flax promotes them), the scores are divided by
sqrt(dg) in fp32 (JAX divides by a numpy float) and the geometric bias is
fp32. So the fused route stays bf16 from end to end, while the dense
route's attention returns fp32 and the rows it updates stay fp32 from there.
"""

from __future__ import annotations

import copy
import functools
import math
from collections import deque
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mega_attention import fused_mega_attention
from ..ops.position_bias import fused_position_bias
from ..utils.precision import cast_floating, compute_dtype as dtype_of

Tensor = torch.Tensor

NEG_INF = -1e9  # additive mask for padded reference slots


# ---------------------------------------------------------------------------
# Position embedding
# ---------------------------------------------------------------------------

def position_matrix(rois: Tensor, ref_rois: Tensor) -> Tensor:
    """Pairwise log-space geometry (N, M, 4): dx, dy normalised by the query
    box and floored as log(|d| + 1e-3), dw, dh as log(query / ref), widths
    and heights with the +1 convention."""
    def cwh(b):
        return (0.5 * (b[..., 0] + b[..., 2]), 0.5 * (b[..., 1] + b[..., 3]),
                b[..., 2] - b[..., 0] + 1.0, b[..., 3] - b[..., 1] + 1.0)

    cx, cy, w, h = cwh(rois)
    rcx, rcy, rw, rh = cwh(ref_rois)
    dx = torch.log(((cx[:, None] - rcx[None, :]) / w[:, None]).abs() + 1e-3)
    dy = torch.log(((cy[:, None] - rcy[None, :]) / h[:, None]).abs() + 1e-3)
    dw = torch.log(w[:, None] / rw[None, :])
    dh = torch.log(h[:, None] / rh[None, :])
    return torch.stack([dx, dy, dw, dh], dim=2)


def position_embedding(pos_mat: Tensor, feat_dim: int = 64,
                       wave_length: float = 1000.0) -> Tensor:
    """(N, M, 4) -> (N, M, feat_dim) sinusoid embedding."""
    feat_range = torch.arange(feat_dim // 8, dtype=pos_mat.dtype,
                              device=pos_mat.device)
    dim_mat = wave_length ** (8.0 / feat_dim * feat_range)
    div = pos_mat[..., None] * 100.0 / dim_mat
    emb = torch.cat([torch.sin(div), torch.cos(div)], dim=-1)
    return emb.reshape(*pos_mat.shape[:2], feat_dim)


def cal_position_embedding(rois: Tensor, ref_rois: Tensor,
                           feat_dim: int = 64) -> Tensor:
    """(N, 4) x (M, 4) -> (N, M, feat_dim)."""
    return position_embedding(position_matrix(rois, ref_rois), feat_dim)


def promoted(*tensors: Tensor) -> list[Tensor]:
    """The tensors in their common dtype, as JAX promotes mixed operands."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    return [t.to(dt) for t in tensors]


def dense(layer: nn.Linear, x: Tensor) -> Tensor:
    """A flax Dense: input, kernel and bias in their common dtype."""
    return F.linear(*promoted(x, layer.weight, layer.bias))


# ---------------------------------------------------------------------------
# Set containers
# ---------------------------------------------------------------------------

class BoxSet(NamedTuple):
    """A padded proposal set: features + boxes + validity."""
    feat: Tensor    # (..., N, D)
    rois: Tensor    # (..., N, 4)
    valid: Tensor   # (..., N) bool


def cat_sets(*sets: BoxSet) -> BoxSet:
    return BoxSet(torch.cat([s.feat for s in sets], dim=-2),
                  torch.cat([s.rois for s in sets], dim=-2),
                  torch.cat([s.valid for s in sets], dim=-1))


def flatten_set(s: BoxSet) -> BoxSet:
    """(F, N, ...) frame-major set -> (F*N, ...)."""
    return BoxSet(s.feat.reshape(-1, s.feat.shape[-1]),
                  s.rois.reshape(-1, 4), s.valid.reshape(-1))


# ---------------------------------------------------------------------------
# The head
# ---------------------------------------------------------------------------

def _dense(in_dim: int, out_dim: int, init: str, device,
           generator) -> nn.Linear:
    """A flax Dense: ``fc`` is uniform(+-sqrt(3 / fan_in)) (make_fc's
    kaiming_uniform(a=1)), ``std`` is normal(0.01); bias 0."""
    lin = nn.Linear(in_dim, out_dim, device=device)
    with torch.no_grad():
        if init == "fc":
            bound = math.sqrt(3.0 / in_dim)
            lin.weight.uniform_(-bound, bound, generator=generator)
        else:
            lin.weight.normal_(0.0, 0.01, generator=generator)
        lin.bias.zero_()
    return lin


class GroupedLinear(nn.Module):
    """The grouped output projection Wv: group g's (D-dim) attention output
    maps to the g-th (D / groups)-slice of the output. ``kernel`` keeps the
    flax layout (groups, D, dg).

    Two identical application orders, chosen by the caller's static cost:
      legacy   concat_g[(att_g @ V) @ W_g]   cost g*N*M*D + g*N*D*dg
      reassoc  concat_g[att_g @ (V @ W_g)]   cost M*D*(g*dg) + g*N*M*dg
    """

    def __init__(self, feat_dim: int, groups: int, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.feat_dim = feat_dim
        self.kernel = nn.Parameter(torch.empty(
            groups, feat_dim, feat_dim // groups, device=device))
        self.bias = nn.Parameter(torch.zeros(feat_dim, device=device))
        with torch.no_grad():
            self.kernel.normal_(0.0, 0.01, generator=generator)

    def project_values(self, values: Tensor) -> Tensor:
        """(M, D) raw value features -> (groups, M, dg), in the values'
        dtype: the kernel is cast to it, as JAX casts it (an fp32 kernel
        on bf16 values is rounded; under bf16 both are bf16 anyway)."""
        return torch.einsum("md,gdo->gmo", values,
                            self.kernel.to(values.dtype))

    def forward(self, per_group: Tensor | None = None, *,
                att: Tensor | None = None,
                values: Tensor | None = None) -> Tensor:
        """per_group (groups, N, D) -> (N, feat_dim) [legacy order], or
        att (groups, N, M) + values (M, D) [reassociated order]."""
        if per_group is not None:
            out = torch.einsum("gnd,gdo->ngo",
                               *promoted(per_group, self.kernel))
        else:
            out = torch.einsum("gnm,gmo->ngo",
                               *promoted(att, self.project_values(values)))
        return out.reshape(-1, self.feat_dim) + self.bias


class MEGAHead(nn.Module):
    """The MEGA attention head over padded proposal sets: per stage
    {l_fc, l_Wg, l_Wq, l_Wk, l_Wv, l_u}, and (global_res_stage + 1) sets of
    {g_Wq, g_Wk, g_Wv, g_u}, under the flax names."""

    def __init__(self, feat_dim: int = 1024, embed_dim: int = 64,
                 groups: int = 16, stage: int = 3, global_res_stage: int = 1,
                 memory_enable: bool = True, global_enable: bool = True,
                 advanced_num: int = 15, fused_pe_bias: bool = False,
                 fused_attention: bool = False, in_dim: int | None = None,
                 *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.feat_dim, self.embed_dim, self.groups = feat_dim, embed_dim, groups
        self.stage, self.global_res_stage = stage, global_res_stage
        self.memory_enable, self.global_enable = memory_enable, global_enable
        self.advanced_num = advanced_num
        self.fused_pe_bias, self.fused_attention = fused_pe_bias, fused_attention
        fd, g = feat_dim, groups
        kw = dict(device=device, generator=generator)
        for i in range(stage):
            # l_fc0 lifts the pooled RoI feature (in_dim, 2048 in the
            # detector) to feat_dim
            fin = in_dim if (i == 0 and in_dim is not None) else fd
            setattr(self, f"l_fc{i}", _dense(fin, fd, "fc", **kw))
            setattr(self, f"l_Wg{i}", _dense(embed_dim, g, "std", **kw))
            setattr(self, f"l_Wq{i}", _dense(fd, fd, "fc", **kw))
            setattr(self, f"l_Wk{i}", _dense(fd, fd, "fc", **kw))
            setattr(self, f"l_Wv{i}", GroupedLinear(fd, g, **kw))
            u = torch.empty(g, fd // g, device=device)
            setattr(self, f"l_u{i}", nn.Parameter(
                u.normal_(0.0, 0.01, generator=generator)))
        if global_enable:
            for i in range(global_res_stage + 1):
                setattr(self, f"g_Wq{i}", _dense(fd, fd, "fc", **kw))
                setattr(self, f"g_Wk{i}", _dense(fd, fd, "fc", **kw))
                setattr(self, f"g_Wv{i}", GroupedLinear(fd, g, **kw))
                u = torch.empty(g, fd // g, device=device)
                setattr(self, f"g_u{i}", nn.Parameter(
                    u.normal_(0.0, 0.01, generator=generator)))

    def routed(self, fused_pe_bias: bool, fused_attention: bool
               ) -> "MEGAHead":
        """A view of this head (sharing its parameters) that takes the given
        attention route."""
        head = copy.copy(self)
        head.fused_pe_bias, head.fused_attention = (fused_pe_bias,
                                                    fused_attention)
        return head

    # -- primitives ---------------------------------------------------------

    def attention(self, roi_feat: Tensor, rois: Tensor | None, ref: BoxSet,
                  index: int, ver: str = "local") -> Tensor:
        """Grouped attention of the (N, D) queries over the reference set
        (M, D)/(M, 4)/(M,). ver="global" takes the g_* parameters and no
        position bias."""
        g = self.groups
        dg = self.feat_dim // g
        p = "g" if ver == "global" else "l"
        wq, wk = getattr(self, f"{p}_Wq{index}"), getattr(self,
                                                          f"{p}_Wk{index}")
        wv, u = getattr(self, f"{p}_Wv{index}"), getattr(self, f"{p}_u{index}")
        q = dense(wq, roi_feat).reshape(-1, g, dg).transpose(0, 1)  # g N dg
        k = dense(wk, ref.feat).reshape(-1, g, dg).transpose(0, 1)  # g M dg
        wg = getattr(self, f"l_Wg{index}") if ver != "global" else None

        if self.fused_attention:
            vproj = wv.project_values(ref.feat)
            # the u-term in fp32 whatever the dtype: JAX divides it by a
            # numpy float, which promotes a bf16 product
            ub = torch.einsum("gd,gmd->gm", *promoted(u, k)).float() \
                / math.sqrt(dg)
            # Wg in fp32 (bf16-rounded under a bf16 head): the bias is fp32
            bias_args = ((rois, ref.rois, wg.weight.T.float(),
                          wg.bias.float()) if wg is not None else ())
            out = fused_mega_attention(q.contiguous(), k.contiguous(), vproj,
                                       ub, ref.valid, *bias_args,
                                       embed_dim=self.embed_dim)
            return out + wv.bias.to(out.dtype)

        # the content scores in q's and k's dtype (a bf16 product is rounded
        # before the fp32 scale, as JAX's dense einsum rounds it)
        aff = torch.einsum("gnd,gmd->gnm", *promoted(q, k))
        aff_c = torch.einsum("gd,gmd->gm", *promoted(u, k))
        aff = (aff + aff_c[:, None, :]).float() / math.sqrt(dg)
        if wg is not None:
            if self.fused_pe_bias:
                bias = fused_position_bias(rois, ref.rois, wg.weight.T.float(),
                                           wg.bias.float(),
                                           embed_dim=self.embed_dim)
            else:
                pe = cal_position_embedding(rois, ref.rois, self.embed_dim)
                bias = torch.log(F.relu(dense(wg, pe)) + 1e-6).permute(2, 0,
                                                                      1)
            aff = aff + bias.to(aff.dtype)
        aff = torch.where(ref.valid[None, None, :], aff, NEG_INF)
        att = torch.softmax(aff, dim=-1)
        att = att * ref.valid[None, None, :].to(att.dtype)
        n, m = att.shape[1], att.shape[2]
        d = ref.feat.shape[-1]
        reassoc_cost = m * d * self.feat_dim + g * n * m * dg
        legacy_cost = g * n * m * d + n * d * self.feat_dim
        if reassoc_cost < legacy_cost:
            return wv(att=att, values=ref.feat)
        return wv(torch.einsum("gnm,md->gnd", *promoted(att, ref.feat)))

    def fc(self, i: int, x: Tensor) -> Tensor:
        return F.relu(dense(getattr(self, f"l_fc{i}"), x))

    def pre_calculate(self, pooled: Tensor) -> Tensor:
        """fc0 on pooled RoI features: the cached window/global features."""
        return self.fc(0, pooled)

    def attend_global(self, x: Tensor, glob: BoxSet | None,
                      index: int) -> Tensor:
        """Residual global attention."""
        if not self.global_enable or glob is None:
            return x
        return x + self.attention(x, None, glob, index, ver="global")

    # -- flows ---------------------------------------------------------------

    def build_memory(self, mem_frames: BoxSet,
                     glob: BoxSet | None) -> list[BoxSet]:
        """The training forward's long-range memory from sampled memory
        frames: the global attention over their flattened fc0-level
        features (F, B, D), then, per stage, the set the stage reads, the
        first ``advanced_num`` rows of each frame lifted through the
        stage's attention and fc. The caller runs it without gradient."""
        a = self.advanced_num
        if a > mem_frames.feat.shape[1]:
            raise ValueError(f"advanced_num {a} > per-frame slots "
                             f"{mem_frames.feat.shape[1]}")
        allset = flatten_set(mem_frames)
        allset = allset._replace(
            feat=self.attend_global(allset.feat, glob, 0))
        f, d = mem_frames.feat.shape[0], self.feat_dim
        cur = allset.feat.reshape(f, -1, d)[:, :a].reshape(-1, d)
        cur_rois = mem_frames.rois[:, :a].reshape(-1, 4)
        cur_valid = mem_frames.valid[:, :a].reshape(-1)
        mem: list[BoxSet] = []
        ref = allset
        for i in range(self.stage):
            mem.append(ref)
            if i == self.stage - 1:
                break
            att = self.attention(cur, cur_rois, ref, i, ver="memory")
            cur = self.fc(i + 1, cur + att)
            cur = cur * cur_valid[:, None].to(cur.dtype)
            ref = BoxSet(cur, cur_rois, cur_valid)
        return mem

    def enhance_train(self, key_pooled: Tensor, key_rois: Tensor,
                      key_valid: Tensor, window: BoxSet,
                      mem_frames: BoxSet | None,
                      glob: BoxSet | None) -> Tensor:
        """The training forward's MEGA flow: the memory built from the
        sampled memory frames without gradient, then ``enhance`` (the
        global set takes gradient there, not through the memory)."""
        mem = None
        if self.memory_enable and mem_frames is not None:
            with torch.no_grad():
                mem = self.build_memory(mem_frames, glob)
        return self.enhance(key_pooled, key_rois, key_valid, window, mem,
                            glob)

    def enhance(self, key_pooled: Tensor, key_rois: Tensor, key_valid: Tensor,
                window: BoxSet, mem: Sequence[BoxSet] | None,
                glob: BoxSet | None, *, key_is_fc0: bool = False,
                return_pushes: bool = False):
        """The local stage flow enhancing the key frame's proposals.

        key_pooled (Nk, in_dim) pooled features of the key set (or fc0-level
        if key_is_fc0); window: fc0-level (F, B, D) frame-major; mem: the
        per-stage memory sets or None. Stage 0 queries [key; distilled
        window] over the window (+ mem[0]); middle stages query the same
        rows over the distilled rows (+ mem[i]); the final stage queries
        the key rows; fc[i+1] after each non-final stage; then the residual
        global stages. Returns (Nk, D) [, the per-stage push sets]."""
        a = self.advanced_num
        nk = key_pooled.shape[0]
        d = self.feat_dim
        f = window.feat.shape[0]
        if a > window.feat.shape[1]:
            raise ValueError(f"advanced_num {a} > per-frame slots "
                             f"{window.feat.shape[1]}")

        x_key = key_pooled if key_is_fc0 else self.fc(0, key_pooled)
        x_key = self.attend_global(x_key, glob, 0)
        ref_all = flatten_set(window)
        ref_all = ref_all._replace(
            feat=self.attend_global(ref_all.feat, glob, 0))
        dis = BoxSet(ref_all.feat.reshape(f, -1, d)[:, :a].reshape(-1, d),
                     window.rois[:, :a].reshape(-1, 4),
                     window.valid[:, :a].reshape(-1))

        cur = torch.cat([x_key, dis.feat])
        cur_rois = torch.cat([key_rois, dis.rois])
        cur_valid = torch.cat([key_valid, dis.valid])
        ref = ref_all
        pushes: list[BoxSet] = []
        for i in range(self.stage):
            if return_pushes:
                # this stage's first frame-slot of its reference set
                n_push = ref.feat.shape[0] // f if i == 0 else a
                pushes.append(BoxSet(ref.feat[:n_push], ref.rois[:n_push],
                                     ref.valid[:n_push]))
            ref_i = cat_sets(ref, mem[i]) if mem is not None else ref
            if i == self.stage - 1:
                cur, cur_rois, cur_valid = (cur[:nk], cur_rois[:nk],
                                            cur_valid[:nk])
            cur = cur + self.attention(cur, cur_rois, ref_i, i)
            if i != self.stage - 1:
                cur = self.fc(i + 1, cur)
                cur = cur * cur_valid[:, None].to(cur.dtype)
                ref = BoxSet(cur[nk:], dis.rois, dis.valid)

        x = cur * key_valid[:, None].to(cur.dtype)
        for i in range(self.global_res_stage if self.global_enable else 0):
            x = self.attend_global(x, glob, i + 1)
            x = x * key_valid[:, None].to(x.dtype)
        if return_pushes:
            return x, pushes
        return x


# ---------------------------------------------------------------------------
# Streaming (whole-video) driver
# ---------------------------------------------------------------------------

class MegaStreamState(NamedTuple):
    """The per-stage memories as ring buffers, oldest frame first."""
    mem_feat: tuple[Tensor, ...]    # per stage: (mem_size, n_i, D)
    mem_rois: tuple[Tensor, ...]    # per stage: (mem_size, n_i, 4)
    mem_valid: tuple[Tensor, ...]   # per stage: (mem_size, n_i)


def init_stream_state(stage: int, mem_size: int, base_num: int,
                      advanced_num: int, feat_dim: int,
                      dtype=torch.float32, device=None) -> MegaStreamState:
    ns = [base_num] + [advanced_num] * (stage - 1)
    return MegaStreamState(
        tuple(torch.zeros((mem_size, n, feat_dim), dtype=dtype, device=device)
              for n in ns),
        tuple(torch.zeros((mem_size, n, 4), device=device) for n in ns),
        tuple(torch.zeros((mem_size, n), dtype=torch.bool, device=device)
              for n in ns))


def window_indices(t: int, seg_len: int, *, window: int = 25,
                   key_loc: int = 12, device=None) -> Tensor:
    """Frame indices of the sliding window at key frame t: [t - key_loc,
    t + window - 1 - key_loc] clamped to [0, seg_len - 1]."""
    offs = torch.arange(window, device=device) - key_loc
    return (t + offs).clamp(0, seg_len - 1)


def global_indices(seg_len: int, global_size: int = 10,
                   shuffle: bool = True, seed: int = 0) -> np.ndarray:
    """(T, G) frame indices of the global set at each key step: at frame 0
    the deque fills with G shuffled frames; each later frame pushes one
    more, evicting the oldest."""
    idx = np.arange(seg_len)
    if shuffle:
        rng = np.random.default_rng(seed)
        rng.shuffle(idx)
    out = np.zeros((seg_len, global_size), np.int64)
    dq: deque = deque(maxlen=global_size)
    for t in range(seg_len):
        size = global_size if t == 0 else 1
        for i in range(size):
            dq.append(idx[(t + global_size - i - 1) % seg_len])
        out[t] = np.array(dq)
    return out


def stream_video(head: MEGAHead, *, key_feat: Tensor, key_rois: Tensor,
                 key_valid: Tensor, key_is_fc0: bool, ref_feat: Tensor,
                 ref_rois: Tensor, ref_valid: Tensor, mem_size: int = 25,
                 window: int = 25, key_loc: int = 12,
                 glob_idx: np.ndarray | None = None,
                 compute_dtype: str = "float32") -> Tensor:
    """Enhance every frame of a video with full MEGA semantics.

    key_feat (T, Nk, .) the per-frame key sets, raw pooled
    (key_is_fc0=False) or fc0-level; ref_feat (T, B, D) fc0-level window
    and global sets; glob_idx (T, G) per-step global frames or None.
    Each step reads the memories before it pushes its own entries.
    compute_dtype="bfloat16" runs the scan in bf16: the head (a
    ``cast_floating`` copy unless it is bf16 already), the features and the
    memories (the rois and masks keep their types). Returns (T, Nk, D)
    fp32."""
    dt = dtype_of(compute_dtype)
    if dt != torch.float32:
        if next(head.parameters()).dtype != dt:
            head = cast_floating(head, dt)
        key_feat, ref_feat = key_feat.to(dt), ref_feat.to(dt)
    t_total, b, d = ref_feat.shape
    dev = ref_feat.device
    use_glob = glob_idx is not None and head.global_enable
    state = init_stream_state(head.stage, mem_size, b, head.advanced_num, d,
                              dtype=ref_feat.dtype, device=dev)
    gidx = torch.as_tensor(glob_idx, device=dev) if use_glob else None
    outs = []
    for t in range(t_total):
        widx = window_indices(t, t_total, window=window, key_loc=key_loc,
                              device=dev)
        win = BoxSet(ref_feat[widx], ref_rois[widx], ref_valid[widx])
        glob = None
        if use_glob:
            gi = gidx[t]
            glob = flatten_set(BoxSet(ref_feat[gi], ref_rois[gi],
                                      ref_valid[gi]))
        mem = None
        if head.memory_enable:
            mem = [flatten_set(BoxSet(state.mem_feat[i], state.mem_rois[i],
                                      state.mem_valid[i]))
                   for i in range(head.stage)]
        out, pushes = head.enhance(key_feat[t], key_rois[t], key_valid[t],
                                   win, mem, glob, key_is_fc0=key_is_fc0,
                                   return_pushes=True)
        # a push takes its memory's dtype (the dense route's fp32 rows are
        # rounded into a bf16 memory, as JAX's .at[].set() casts them)
        state = MegaStreamState(*(
            tuple(torch.cat([buf[1:], getattr(p, field)[None].to(buf.dtype)])
                  for buf, p in zip(bufs, pushes))
            for bufs, field in zip(state, ("feat", "rois", "valid"))))
        outs.append(out)
    return torch.stack(outs).float()
