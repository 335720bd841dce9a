"""Llama-family decoder: GQA + RoPE + SwiGLU (or an MoE FFN) on the
port's ops.

Port of `ray_tpu/models/transformer.py`. Parameters are a plain dict, as
in the JAX package, with one difference: the layers are a list of
per-layer dicts instead of arrays stacked on a leading layers axis
(PyTorch runs the layer loop eagerly; there is no scan to feed). Every
leaf is stored in the parameter dtype and cast to the activation dtype
at each use, as the JAX package does, so training differentiates and
updates the parameter-dtype leaves (f32 master weights under the default
config). Serving casts the matmul weights once instead
(`models/convert.py::cast_for_serving`), after which the casts at use
are free.

With a `mesh` (a `DeviceMesh` from `parallel.prepare_mesh`), the
parameters are DTensors placed by `param_logical_axes()` through
`parallel.param_shardings`/`shard_pytree`, every rank passes the whole
batch, activations are redistributed at each constraint of the JAX
model (`_constrain`), and the kernels run on local shards inside
`local_map` (`ops/sharded.py`); ring attention takes the sp axis and the
MoE's experts the ep axis. `loss` gives the same plain scalar on every
rank; `hidden` and `apply` give DTensors. The embedding is a
vocab-sharded lookup where the JAX model contracts a one-hot (the same
numbers). On a mesh with pp > 1 and `pipeline_microbatches > 0` the
layers run as a GPipe pipeline over pp (`parallel/pipeline.py`): each pp
rank runs its own stage's layers, and every rank gets the last stage's
hidden states, as the JAX model's `pipeline_apply` gives them.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.models.moe import MOE_PARAM_AXES, ExpertShards, moe_ffn
from ray_tpu_torch.ops.attention import attn_remat_policy, flash_attention
from ray_tpu_torch.ops.dispatch import resolve_device
from ray_tpu_torch.ops.losses import (chunked_ce_sum, chunked_lm_loss,
                                      sharded_softmax_cross_entropy,
                                      softmax_cross_entropy)
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.ring_attention import ring_attention_sharded
from ray_tpu_torch.ops.rope import apply_rope_cached, rope_cos_sin
from ray_tpu_torch.ops.sharded import (flash_attention_sharded,
                                       rms_norm_sharded, sharded_linear,
                                       vocab_sharded_lookup)
from ray_tpu_torch.parallel.mesh import axis_sizes, compute_mesh
from ray_tpu_torch.parallel.pipeline import pipeline_apply
from ray_tpu_torch.parallel.sharding import (LOGICAL_AXIS_RULES,
                                             logical_placements,
                                             with_logical_constraint)

Params = Dict[str, Any]

NORMS = ("attn_norm", "mlp_norm", "final_norm")

# The sharding rules plus the activation-only logical axes (params use
# the rules in parallel.sharding directly).
_RULES = {**LOGICAL_AXIS_RULES, "act_embed": None, "expert_capacity": None}


def _rows_like(c: torch.Tensor, xm: torch.Tensor) -> torch.Tensor:
    """The first rows of `c` (a full-batch cache) for microbatch `xm`,
    taken from each rank's local rows when both are DTensors."""
    if isinstance(c, DTensor):
        rows = xm.to_local().shape[0]
        return DTensor.from_local(c.to_local()[:rows], c.device_mesh,
                                  c.placements, run_check=False)
    return c[:xm.shape[0]]


class Transformer(nn.Module):
    """Functional model for one TransformerConfig: `init` makes the
    parameters, `apply(params, tokens)` runs the forward and
    `loss(params, batch)` the causal LM loss."""

    def __init__(self, config: TransformerConfig, mesh=None):
        super().__init__()
        self.config = config
        self.mesh = mesh
        # the mesh DTensors live on: `mesh` less its size-1 axes
        self._dmesh = None if mesh is None else compute_mesh(mesh)

    # ------------------------------------------------------------ init
    def init(self, seed: int, device=None) -> Params:
        """Random parameters from `seed`, made on `device` (default: the
        card), every leaf in the parameter dtype. Same structure and
        scales as the JAX `init`; the numbers differ, as torch and JAX
        generators do."""
        return self.init_leaves(seed, device, lambda name, t: t)

    def init_leaves(self, seed: int, device,
                    finish: Callable[[str, torch.Tensor], torch.Tensor]
                    ) -> Params:
        """`init`, with `finish(name, leaf)` applied to each leaf as soon
        as it is made, so a transform (the serving cast) never holds the
        whole parameter-dtype model at once."""
        c = self.config
        dev = resolve_device(device)
        pd = c.parameter_dtype
        e, f, hd = c.d_model, c.d_ff, c.head_dim
        qd, kvd = c.n_heads * hd, c.kv_heads * hd
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        std = 0.02
        out_std = std / math.sqrt(2 * c.n_layers)

        def w(name, shape, scale):
            x = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32)
            return finish(name, x.mul_(scale).to(pd))

        def zeros(name):
            return finish(name, torch.zeros((e,), dtype=pd, device=dev))

        E = c.moe_num_experts
        layers = []
        for _ in range(c.n_layers):
            layer = {
                "attn_norm": zeros("attn_norm"),
                "wq": w("wq", (e, qd), std),
                "wk": w("wk", (e, kvd), std),
                "wv": w("wv", (e, kvd), std),
                "wo": w("wo", (qd, e), out_std),
                "mlp_norm": zeros("mlp_norm"),
            }
            if E:
                layer.update({
                    "router": w("router", (e, E), std),
                    "moe_gate": w("moe_gate", (E, e, f), std),
                    "moe_up": w("moe_up", (E, e, f), std),
                    "moe_down": w("moe_down", (E, f, e), out_std),
                })
            else:
                layer.update({
                    "gate": w("gate", (e, f), std),
                    "up": w("up", (e, f), std),
                    "down": w("down", (f, e), out_std),
                })
            layers.append(layer)
        params: Params = {
            "embed": w("embed", (c.vocab_size, e), std),
            "layers": layers,
            "final_norm": zeros("final_norm"),
        }
        if not c.tie_embeddings:
            params["lm_head"] = w("lm_head", (e, c.vocab_size), std)
        return params

    def param_logical_axes(self) -> Params:
        """The parameter tree with each leaf's logical axes, per layer as
        the port keeps its layers (the JAX tree's, less the leading
        "layers" axis)."""
        layer = {
            "attn_norm": ("embed",),
            "wq": ("embed", "heads"),
            "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"),
            "wo": ("heads", "embed"),
            "mlp_norm": ("embed",),
        }
        if self.config.moe_num_experts:
            layer.update(MOE_PARAM_AXES)
        else:
            layer.update({
                "gate": ("embed", "mlp"),
                "up": ("embed", "mlp"),
                "down": ("mlp", "embed"),
            })
        axes = {
            "embed": ("vocab", "embed"),
            "layers": [dict(layer) for _ in range(self.config.n_layers)],
            "final_norm": ("embed",),
        }
        if not self.config.tie_embeddings:
            axes["lm_head"] = ("embed", "vocab")
        return axes

    # --------------------------------------------------------- forward
    def _constrain(self, x, axes):
        if self.mesh is None:
            return x
        return with_logical_constraint(x, axes, mesh=self.mesh,
                                       rules=_RULES)

    def _mesh_size(self, axis: str) -> int:
        return 1 if self.mesh is None else axis_sizes(self.mesh).get(axis, 1)

    def _embed_lookup(self, table: torch.Tensor,
                      tokens: torch.Tensor) -> torch.Tensor:
        # gather, then cast: the same values as casting the table first
        ad = self.config.activation_dtype
        if self.mesh is None:
            return table[tokens].to(ad)
        return vocab_sharded_lookup(table, tokens, self._dmesh,
                                    _RULES).to(ad)

    def _mm(self, x, w):
        """x @ w in the activation dtype (the weight cast at use)."""
        w = w.to(self.config.activation_dtype)
        return x @ w if self.mesh is None else sharded_linear(x, w)

    def _norm(self, x, w):
        if self.mesh is None:
            return rms_norm(x, w, self.config.norm_eps)
        return rms_norm_sharded(x, w, self.config.norm_eps)

    def _attention(self, q, k, v):
        c = self.config
        if self.mesh is None:
            return flash_attention(q, k, v, causal=True,
                                   block_q=c.attn_block_q,
                                   block_k=c.attn_block_k)
        if c.use_ring_attention and self._mesh_size("sp") > 1:
            return ring_attention_sharded(q, k, v, self._dmesh, causal=True)
        return flash_attention_sharded(q, k, v, self._dmesh, causal=True)

    def _layer(self, x: torch.Tensor, layer: Params, cos: torch.Tensor,
               sin: torch.Tensor):
        """One block; returns (x, MoE load-balance loss), the loss 0.0 for
        the dense FFN."""
        c = self.config
        ad = c.activation_dtype
        b, s, _ = x.shape
        hd = c.head_dim

        h = self._norm(x, layer["attn_norm"])
        q = self._mm(h, layer["wq"]).view(b, s, c.n_heads, hd)
        k = self._mm(h, layer["wk"]).view(b, s, c.kv_heads, hd)
        v = self._mm(h, layer["wv"]).view(b, s, c.kv_heads, hd)
        q = apply_rope_cached(q, cos, sin)
        k = apply_rope_cached(k, cos, sin)
        q = self._constrain(q.transpose(1, 2),
                            ("batch", "heads", "seq", "head_dim"))
        attn = self._attention(q, k.transpose(1, 2), v.transpose(1, 2))
        attn = attn.transpose(1, 2).reshape(b, s, c.n_heads * hd)
        x = x + self._mm(attn, layer["wo"])
        x = self._constrain(x, ("batch", "seq", "act_embed"))

        h = self._norm(x, layer["mlp_norm"])
        if c.moe_num_experts:
            y, lb = self._moe(h, layer)
            return self._constrain(x + y, ("batch", "seq", "act_embed")), lb
        gate = F.silu(self._mm(h, layer["gate"]))
        up = self._mm(h, layer["up"])
        mlp = self._constrain(gate * up, ("batch", "seq", "mlp"))
        x = x + self._mm(mlp, layer["down"])
        return self._constrain(x, ("batch", "seq", "act_embed")), 0.0

    def _moe(self, h, layer: Params):
        """(MoE FFN output, load-balance loss). Under a mesh `moe_ffn`
        runs on every rank inside `local_map` with the tokens whole, the
        router whole, and the experts' weights split over ep (experts) and
        tp (mlp), whole along embed; `ExpertShards` is its constrain hook.
        The output is the same on every rank."""
        c = self.config
        names = ("router", "moe_gate", "moe_up", "moe_down")
        weights = [layer[n] for n in names]

        def run(x, *w, constrain=None):
            y, aux = moe_ffn(x, *w, top_k=c.moe_top_k,
                             capacity_factor=c.moe_capacity_factor,
                             constrain=constrain)
            return y, aux["moe_load_balance_loss"]

        if self.mesh is None:
            return run(h, *weights)
        mesh = self._dmesh
        whole = [Replicate()] * mesh.ndim
        wp = [logical_placements(self.mesh, tuple(
            None if a == "embed" else a for a in MOE_PARAM_AXES[n]), _RULES)
            for n in names]
        inp = (whole, *wp)
        return local_map(
            lambda x, *w: run(x, *w, constrain=ExpertShards(mesh)),
            out_placements=(whole, whole), in_placements=inp,
            in_grad_placements=inp, device_mesh=mesh,
            redistribute_inputs=True)(h, *weights)

    def hidden(self, params: Params, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Trunk: tokens (b, s) -> post-final-norm hidden states (b, s, e)."""
        return self.hidden_and_aux(params, tokens, positions)[0]

    def hidden_and_aux(self, params: Params, tokens: torch.Tensor,
                       positions: Optional[torch.Tensor] = None):
        """(hidden states, MoE load-balance loss summed over the layers).

        With `config.remat` each layer runs under
        `torch.utils.checkpoint` (non-reentrant) when a gradient is being
        taken: its activations are recomputed in the backward. Under
        `remat_policy="full"` that includes the flash forward kernel;
        under `"save_attn"` the checkpoint keeps the kernel's O and lse
        from the forward and replays them in the recompute
        (`attn_remat_policy`), so each layer runs it once.
        """
        c = self.config
        b, s = tokens.shape
        pipelined = self._mesh_size("pp") > 1 and c.pipeline_microbatches > 0
        if pipelined and c.moe_num_experts:
            raise NotImplementedError(
                "MoE + pipeline parallelism is not supported yet "
                "(the pipeline stage carries activations only)")
        if pipelined and positions is not None:
            raise NotImplementedError(
                "pipeline parallelism assumes default positions "
                "(rope caches are sliced per microbatch, which is "
                "only exact when rows share the arange positions); "
                "pass positions=None with pp>1")
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        # under a mesh, every rank holds the whole batch and takes its
        # rows and sequence shard (no communication)
        tokens = self._constrain(tokens, ("batch", "seq"))
        x = self._embed_lookup(params["embed"], tokens)
        x = self._constrain(x, ("batch", "seq", "act_embed"))
        cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
        cos = self._constrain(cos, ("batch", "seq", None, None))
        sin = self._constrain(sin, ("batch", "seq", None, None))
        remat = c.remat and torch.is_grad_enabled()
        context_fn = (attn_remat_policy() if c.remat_policy == "save_attn"
                      else noop_context_fn)

        def run_layer(x, layer, cos, sin):
            if remat and torch.is_grad_enabled():
                return checkpoint(self._layer, x, layer, cos, sin,
                                  use_reentrant=False, context_fn=context_fn)
            return self._layer(x, layer, cos, sin)

        if pipelined:
            # rope rides as consts, full-batch; rows are identical
            # (positions broadcast from arange), so a microbatch takes
            # the first rows of each rank's local caches
            def stage(stage_layers, xm, cos, sin):
                cm, sm = _rows_like(cos, xm), _rows_like(sin, xm)
                for layer in stage_layers:
                    xm, _ = run_layer(xm, layer, cm, sm)
                return xm

            x = pipeline_apply(self.mesh, stage, params["layers"], x,
                               c.pipeline_microbatches, consts=(cos, sin))
            return self._norm(x, params["final_norm"]), 0.0
        moe_aux = 0.0
        for layer in params["layers"]:
            x, lb = run_layer(x, layer, cos, sin)
            moe_aux = moe_aux + lb
        return self._norm(x, params["final_norm"]), moe_aux

    def _head(self, params: Params) -> torch.Tensor:
        head = (params["embed"].T if self.config.tie_embeddings
                else params["lm_head"])
        return head.to(self.config.activation_dtype)

    def apply(self, params: Params, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (b, s) int -> logits (b, s, vocab) in f32."""
        x = self.hidden(params, tokens, positions)
        logits = self._constrain(self._mm(x, self._head(params)),
                                 ("batch", "seq", "vocab"))
        return logits.to(torch.float32)

    forward = apply

    # ------------------------------------------------------------ loss
    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Causal LM loss (a 0-d f32 tensor). batch: tokens (b, s);
        optional loss_mask (b, s) aligned with tokens-as-labels:
        loss_mask[i] = 0 excludes token i from being a prediction target.
        An MoE model adds `moe_aux_coef` times its load-balance loss,
        averaged over the layers. Under a mesh every rank passes the
        whole batch and gets the same scalar."""
        tokens = batch["tokens"].long()
        mask = batch.get("loss_mask")
        if self.mesh is not None:
            return self._mesh_loss(params, tokens, mask)
        x, aux = self.hidden_and_aux(params, tokens)
        return self._with_moe_term(self._lm_loss(params, x, tokens, mask),
                                   aux)

    def _with_moe_term(self, loss, aux):
        c = self.config
        if not c.moe_num_experts:
            return loss
        return loss + c.moe_aux_coef * aux / c.n_layers

    def _lm_loss(self, params: Params, x, tokens, mask):
        c = self.config
        if c.loss_chunk:
            # Full-length formulation (keeps seq divisible by the chunk):
            # labels[i] = tokens[i+1], the final position masked out.
            b, s = tokens.shape
            labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
            m = (torch.ones((b, s), dtype=torch.float32,
                            device=tokens.device)
                 if mask is None else mask.to(torch.float32))
            m = torch.cat([m[:, 1:], torch.zeros_like(m[:, :1])], dim=1)
            return chunked_lm_loss(x, self._head(params), labels, m,
                                   chunk_size=c.loss_chunk)
        logits = (x @ self._head(params)).to(torch.float32)[:, :-1]
        if mask is not None:
            mask = mask[:, 1:]
        loss, _ = softmax_cross_entropy(logits, tokens[:, 1:], mask=mask)
        return loss

    def _mesh_loss(self, params: Params, tokens, mask) -> torch.Tensor:
        """The loss over the mesh, in the full-length formulation (labels
        shifted left, the last position masked out) so labels keep the
        tokens' sharding. Per-token CE runs on each rank's rows inside
        `local_map`: `sharded_softmax_cross_entropy` over tp where the
        vocab is split, `softmax_cross_entropy` where it is whole."""
        c = self.config
        b, s = tokens.shape
        x, aux = self.hidden_and_aux(params, tokens)
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        m = (torch.ones((b, s), dtype=torch.float32, device=tokens.device)
             if mask is None else mask.to(torch.float32))
        m = torch.cat([m[:, 1:], torch.zeros_like(m[:, :1])], dim=1)
        labels = self._constrain(labels, ("batch", "seq"))
        m = self._constrain(m, ("batch", "seq"))
        tp = self._mesh_size("tp")

        def per_token(lg, lb):
            if tp > 1:
                return sharded_softmax_cross_entropy(
                    lg, lb, "tp", c.vocab_size // tp, mesh=self._dmesh)[1]
            return softmax_cross_entropy(lg, lb)[1]

        rp = logical_placements(self.mesh, ("batch", "seq"), _RULES)
        if c.loss_chunk:
            # the chunked CE on each rank's rows: x whole along embed,
            # the head split over tp along vocab where it is split. The
            # sum over a rank's rows, and the head's gradient from them,
            # are partial sums over the row axes; x's gradient from a
            # vocab shard is a partial sum over tp
            xp = logical_placements(self.mesh, ("batch", "seq", None),
                                    _RULES)
            hp = logical_placements(self.mesh, (None, "vocab"), _RULES)

            def partial_where(split, other):
                return tuple(Partial() if isinstance(q, Shard) else o
                             for q, o in zip(split, other))
            total = local_map(
                lambda xl, hl, lb, ml: chunked_ce_sum(
                    xl, hl, lb, ml, c.loss_chunk, per_token),
                out_placements=list(partial_where(rp, [Replicate()] *
                                                  len(rp))),
                in_placements=(xp, hp, rp, rp),
                in_grad_placements=(partial_where(hp, xp),
                                    partial_where(rp, hp), rp, rp),
                device_mesh=self._dmesh,
                redistribute_inputs=True)(x, self._head(params), labels, m)
            loss = total / m.sum().clamp_min(1.0)
            return self._with_moe_term(loss, aux).full_tensor()
        logits = self._constrain(self._mm(x, self._head(params)),
                                 ("batch", "seq", "vocab"))
        lp = logical_placements(self.mesh, ("batch", "seq", "vocab"),
                                _RULES)
        pt = local_map(per_token, out_placements=list(rp),
                       in_placements=(lp, rp),
                       device_mesh=self._dmesh, redistribute_inputs=True)(
                           logits, labels)
        loss = (pt * m).sum() / m.sum().clamp_min(1.0)
        return self._with_moe_term(loss, aux).full_tensor()
