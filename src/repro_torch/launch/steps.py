"""Step functions (the port of ``repro/launch/steps.py``): the training
step (loss, gradients with optional accumulation and remat, AdamW), the
lockstep prefill and decode steps of the dry-run, the serving steps:
ragged decode over the paged KV pool or the per-slot ring, batched
prefill into either, self-speculative draft + verify, and in-step
sampling; and ``input_specs``, every input of a dry-run cell as meta
tensors.

Each step samples on the device, so only the next token ids (and, for a
speculative tick, the accept lengths) cross to the host. Caches are
written in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, RunConfig, ShapeConfig
from repro_torch.distributed.dtensor import placed_like, replicating
from repro_torch.distributed.dtensor import unshard
from repro_torch.models.model import forward, init_cache
from repro_torch.optim import adamw_update, cosine_warmup
from repro_torch.tree import tree_leaves, tree_unflatten


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy in f32. Vocab-sharded logits (a DTensor)
    are gathered over the vocab first, the port's choice where the
    reference keeps them sharded: DTensor's gather on a sharded dim
    leaves a masked partial sum that the subtraction cannot take."""
    lf = unshard(logits, -1).to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.to(torch.int64)[..., None])[..., 0]
    return torch.mean(lse - tgt)


def make_loss_fn(cfg: ArchConfig, run: RunConfig):
    """loss_fn(params, batch) -> (loss + 0.01 x the MoE aux loss, the raw
    loss). ``batch``: ``tokens``, ``targets`` [B, S] and optionally
    ``prefix_embeds`` [B, P, D], whose positions carry no LM target."""

    def loss_fn(params, batch):
        prefix = batch.get("prefix_embeds")
        logits, aux = forward(params, batch["tokens"], cfg,
                              prefix_embeds=prefix, return_aux=True,
                              remat=(run.remat == "block"))
        if prefix is not None:  # frontend stub tokens carry no LM targets
            logits = logits[:, prefix.shape[1]:]
        loss = lm_loss(logits, batch["targets"])
        return loss + 0.01 * aux, loss

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(raw loss, gradients in the parameters' structure) of ``loss_fn``'s
    first output. A parameter the loss does not reach gets zeros, as
    under ``jax.grad``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    total, raw = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else placed_like(g, p)
             for p, g in zip(leaves, grads)]
    return raw.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, run: RunConfig):
    """train_step(params, opt_state, batch) -> (new params, new AdamW
    state, {"loss", "lr", "grad_norm"}), out of place.

    ``run.grad_accum`` > 1 splits the batch into that many micro-batches
    (rows ``i*mb:(i+1)*mb``), sums their gradients in f32 buffers and
    divides at the end, as the reference's scan does; the loss is the
    mean of the micro-batches' raw losses.

    On parameters, moments and a batch of DTensors (placed by
    ``distributed.sharding``) the step runs sharded, and every new leaf
    keeps the placements its input had."""
    loss_fn = make_loss_fn(cfg, run)

    def train_step(params, opt_state, batch):
        with replicating(*tree_leaves(params)):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        lr = cosine_warmup(opt_state.step, peak_lr=run.learning_rate,
                           warmup=run.lr_warmup)
        if run.grad_accum > 1:
            mb = batch["tokens"].shape[0] // run.grad_accum
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=lr.device)
            for i in range(run.grad_accum):
                sl = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                raw, g = value_and_grad(loss_fn, params, sl)
                gsum = [a + b for a, b in zip(gsum, tree_leaves(g))]
                loss = loss + raw / run.grad_accum
            grads = tree_unflatten(params,
                                   [g / run.grad_accum for g in gsum])
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        new_params, new_opt, metrics = adamw_update(
            grads, opt_state, params, lr,
            weight_decay=run.weight_decay, grad_clip=run.grad_clip)
        # a sharded step's scalars come out replicated, as the reference's
        return new_params, new_opt, {"loss": unshard(loss), "lr": lr,
                                     "grad_norm": unshard(
                                         metrics["grad_norm"])}

    return train_step


def _greedy_last(logits: torch.Tensor) -> torch.Tensor:
    """int32 argmax of each row's last logits in f32 (a vocab-sharded
    DTensor gathered over the vocab first)."""
    last = unshard(logits[:, -1], -1).to(torch.float32)
    return torch.argmax(last, dim=-1).to(torch.int32)


def make_prefill_step(cfg: ArchConfig, run: RunConfig):
    """prefill_step(params, batch, cache) -> (next ids [B] int32, cache):
    the lockstep prefill of the reference, every prompt of ``batch``
    (``tokens`` [B, S], optional ``prefix_embeds``) written into the
    ring ``cache`` (``init_cache``) from column 0, IN PLACE (the cache
    returned is the one given), and greedy next ids."""

    def prefill_step(params, batch, cache):
        logits = forward(params, batch["tokens"], cfg, cache=cache,
                         cache_index=0,
                         prefix_embeds=batch.get("prefix_embeds"))
        return _greedy_last(logits), cache

    return prefill_step


def make_serve_step(cfg: ArchConfig, run: RunConfig):
    """serve_step(params, tokens, cache, pos) -> (next ids [B] int32,
    cache): one lockstep decode step of the reference, tokens [B, 1] at
    position ``pos`` for every row, written into the ring ``cache`` IN
    PLACE. ``pos`` is an int or a 0-d integer tensor, which is read to
    the host (the ring's column is a slice)."""

    def serve_step(params, tokens, cache, pos):
        pos = int(pos)
        positions = torch.full((tokens.shape[0], 1), pos,
                               dtype=torch.int32, device=tokens.device)
        logits = forward(params, tokens, cfg, positions=positions,
                         cache=cache, cache_index=pos)
        return _greedy_last(logits), cache

    return serve_step


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temperature: float) -> torch.Tensor:
    """Greedy at temperature == 0 (argmax; ties go to the first index, as
    in the reference), Gumbel-max otherwise: argmax(logits / T + g) with
    g ~ Gumbel(0, 1) drawn from ``generator``. This samples the same
    distribution as the reference, softmax(logits / T), but not the same
    draws (the reference's noise comes from ``jax.random``); a fixed
    generator seed makes it reproducible."""
    lf = logits.to(torch.float32)
    if temperature <= 0:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    u = torch.rand(lf.shape, generator=generator, device=lf.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(lf / max(temperature, 1e-6) + g, dim=-1).to(
        torch.int32)


def make_ragged_serve_step(cfg: ArchConfig, max_len: int):
    """Position-ragged decode against the per-slot KV ring: every slot
    advances at its own position, its token's K/V written at its own
    column of its own ring row (``layers._cache_write`` with per-row
    offsets). Inactive rows still write, at a clamped offset of their
    own row: harmless, since admission resets a slot's row."""

    def ragged_serve_step(params, tokens, cache, positions, active,
                          generator, temperature):
        """tokens [B, 1]; positions [B]; active [B] bool. Returns the
        next ids [B] int32, -1 where inactive."""
        pos = positions.to(torch.int64).clamp(0, max_len - 1)
        logits = forward(params, tokens, cfg, positions=pos[:, None],
                         cache=cache, cache_index=pos)
        nxt = sample_tokens(logits[:, -1], generator, temperature)
        return torch.where(active, nxt, -1)

    return ragged_serve_step


def make_batched_prefill_step(cfg: ArchConfig, max_len: int, kv_bits=None):
    """Bucket-padded batched prefill for the ring: the prompts run
    through ONE forward into a fresh ring of their rows (padding at
    position -1 stays masked), then each row replaces its target slot's
    row of the engine's ring, on the device."""

    def batched_prefill_step(params, tokens, lens, slot_map, cache,
                             generator, temperature):
        """tokens [N, Lb] right-padded, a row a request; lens [N];
        slot_map [N] the distinct target slot of each row. Returns the
        first generated id per row."""
        nb, lb = tokens.shape
        dev = tokens.device
        t_idx = torch.arange(lb, device=dev)[None, :]
        pos = torch.where(t_idx < lens[:, None], t_idx, -1)
        fresh = init_cache(cfg, nb, max_len, kv_bits=kv_bits, device=dev)
        logits = forward(params, tokens, cfg, positions=pos, cache=fresh,
                         cache_index=0)
        last = logits[torch.arange(nb, device=dev), (lens - 1).clamp(min=0)]
        for ring, filled in zip(cache["layers"], fresh["layers"]):
            for name, c in ring.items():
                c.index_copy_(0, slot_map, filled[name])
        return sample_tokens(last, generator, temperature)

    return batched_prefill_step


def make_paged_ragged_serve_step(cfg: ArchConfig, max_len: int,
                                 page_size: int, paged_attn: str = "fused"):
    """Position-ragged decode against the paged KV pool: every slot
    advances at its own position. Row i's token is written at page
    ``page_table[i, pos_i // page_size]``; rows whose table row is all -1
    (inactive slots) write nowhere and read no key. Attention runs the
    fused paged decode kernel (``paged_attn="fused"``) or the dense page
    gather (``"gather"``, the reference path)."""
    if paged_attn not in ("fused", "gather"):
        raise ValueError(f"unknown paged_attn {paged_attn!r}")

    def paged_ragged_serve_step(params, tokens, cache, positions, active,
                                page_table, generator, temperature):
        """tokens [B, 1]; positions [B]; active [B] bool. Writes the
        tokens' K/V into ``cache`` in place; returns the next ids [B]
        int32, -1 where inactive."""
        pos = positions.to(torch.int64).clamp(0, max_len - 1)
        logits = forward(
            params, tokens, cfg, positions=pos[:, None], cache=cache,
            page_table=page_table, page_size=page_size,
            paged_attn=paged_attn,
        )
        nxt = sample_tokens(logits[:, -1], generator, temperature)
        return torch.where(active, nxt, -1)

    return paged_ragged_serve_step


def make_paged_prefill_step(cfg: ArchConfig, page_size: int):
    """Bucket-padded batched prefill writing straight into the page pool,
    a row a request.

    Each row carries its UNSHARED prompt suffix, written from its first
    unshared position ``starts[row]``; shared prefix pages are in the
    row's table, so the suffix attends to them without rewriting them.
    Padding tokens (position -1) write nothing.
    """

    def paged_prefill_step(params, tokens, lens, starts, page_table, cache,
                           generator, temperature):
        """tokens [N, Lb] right-padded; lens, starts [N]; page_table
        [N, n_pp]. Writes K/V into ``cache`` in place; returns the first
        generated id per row."""
        lb = tokens.shape[1]
        t_idx = torch.arange(lb, device=tokens.device)[None, :]
        pos = torch.where(t_idx < lens[:, None], starts[:, None] + t_idx, -1)
        logits = forward(
            params, tokens, cfg, positions=pos, cache=cache,
            page_table=page_table, page_size=page_size,
        )
        last = logits[torch.arange(tokens.shape[0], device=tokens.device),
                      (lens - 1).clamp(min=0)]
        return sample_tokens(last, generator, temperature)

    return paged_prefill_step


# ---------------------------------------------------------------------------
# self-speculative decoding: low-bit draft + multi-token paged verify
# ---------------------------------------------------------------------------
#
# One tick: the DRAFT model (the same weights SAMD-packed to a lower bit
# width) proposes K tokens per slot with K single-token forwards, then the
# TARGET verifies all K in ONE multi-token forward. Greedy verification is
# token-identical to plain decode; temperature > 0 uses rejection sampling
# (accept d with probability min(1, p_t(d) / p_d(d)), resample the first
# reject from the residual (p_t - p_d)+), so the output distribution is
# the target's.
#
# Draft KV never touches the page pool: each draft forward writes its K/V
# into a K-column bf16 ring that lives only inside the tick, and reads the
# pool STRICTLY BELOW the tick's window base (the pool may hold a previous
# tick's rejected-draft KV at >= the base). The verify writes all K+1
# tokens through the page table; positions past a slot's ``spec_len``
# budget are -1 (no write, logits ignored).

def speculative_accept(logits: torch.Tensor, draft_tok: torch.Tensor,
                       draft_logits: torch.Tensor, spec_len: torch.Tensor,
                       generator: torch.Generator, temperature: float):
    """Per-slot accept lengths and output tokens for one speculative tick.

    logits [B, K+1, V] target logits at window positions ``pos..pos+K``
    (index j > spec_len[b] is garbage, masked by the budget); draft_tok
    [B, K]; draft_logits [B, K, V]; spec_len [B] draft budgets (0..K).

    Returns (out [B, K+1] int32, n_acc [B] int32): the tick emits
    ``out[b, :n_acc[b] + 1]``. Greedy: out is the target's argmax (first
    maximum) at every position and n_acc counts the leading drafts that
    match it. Sampled: the accepted drafts, then the residual resample at
    the first reject, or the target's own (bonus) sample when every
    budgeted draft was accepted. The reference draws the same
    distributions from ``jax.random``; here the uniforms and the Gumbel
    noise come from ``generator``.
    """
    b, k1, v = logits.shape
    k = k1 - 1
    dev = logits.device
    lf = logits.to(torch.float32)
    j_idx = torch.arange(1, k + 1, device=dev)[None, :]
    in_budget = j_idx <= spec_len.to(torch.int64)[:, None]
    if temperature <= 0:
        tgt = torch.argmax(lf, dim=-1).to(torch.int32)
        match = (draft_tok.to(torch.int32) == tgt[:, :k]) & in_budget
        n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        return tgt, n_acc.to(torch.int32)
    t = max(temperature, 1e-6)
    dt = draft_tok.to(torch.int64)
    pt = torch.softmax(lf[:, :k] / t, dim=-1)
    pd = torch.softmax(draft_logits.to(torch.float32) / t, dim=-1)
    pt_d = torch.gather(pt, 2, dt[..., None])[..., 0]
    pd_d = torch.gather(pd, 2, dt[..., None])[..., 0]
    ratio = pt_d / pd_d.clamp(min=1e-30)
    u = torch.rand((b, k), generator=generator, device=dev)
    ok = (u <= ratio.clamp(max=1.0)) & in_budget
    n_acc = torch.cumprod(ok.to(torch.int64), dim=1).sum(dim=1)
    rows = torch.arange(b, device=dev)
    j_rep = n_acc.clamp(0, k - 1)
    resid = (pt[rows, j_rep] - pd[rows, j_rep]).clamp(min=0.0)
    resid = torch.where(resid.sum(dim=-1, keepdim=True) > 0, resid,
                        pt[rows, j_rep])
    lg_bonus = lf[rows, n_acc]
    u = torch.rand((b, v), generator=generator, device=dev)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    resample = torch.argmax(torch.log(resid.clamp(min=1e-30)) + g, dim=-1)
    bonus = torch.argmax(lg_bonus / t + g, dim=-1)
    repl = torch.where(n_acc >= spec_len.to(torch.int64), bonus, resample)
    j_grid = torch.arange(k + 1, device=dev)[None, :]
    drafts_pad = torch.cat([dt, dt[:, -1:]], dim=1)
    out = torch.where(j_grid < n_acc[:, None], drafts_pad, repl[:, None])
    return out.to(torch.int32), n_acc.to(torch.int32)


def make_draft_step(cfg: ArchConfig, max_len: int, page_size: int,
                    k_spec: int, paged_attn: str = "fused"):
    """Draft half of the speculative tick: ``k_spec`` single-token low-bit
    forwards per slot. Each writes its K/V into a tick-local bf16 ring
    (``init_cache(cfg, B, k_spec)``, never the pool) and reads the pool
    only below the window base; attention runs the decode kernel with
    the ring fold (``paged_attn="fused"``) or the dense gather of the
    pool beside the ring (``"gather"``). Returns (draft_tok [B, K]
    int32, draft_logits [B, K, V])."""
    if k_spec < 1:
        raise ValueError(f"k_spec must be >= 1, got {k_spec}")

    def draft_step(draft_params, tokens, cache, positions, page_table,
                   generator, temperature):
        b = tokens.shape[0]
        pos = positions.to(torch.int64).clamp(0, max_len - 1)
        pool_bound = pos - 1  # pool history strictly below the window
        ring = init_cache(cfg, b, k_spec, device=tokens.device)
        cur = tokens
        drafts, dlogits = [], []
        for j in range(k_spec):
            lg = forward(
                draft_params, cur, cfg, positions=(pos + j)[:, None],
                cache=ring, cache_index=j, page_table=page_table,
                page_size=page_size, paged_attn=paged_attn,
                pool_cache=cache,
                pool_bound=pool_bound,
            )[:, -1]
            d = sample_tokens(lg, generator, temperature)
            drafts.append(d)
            dlogits.append(lg)
            cur = d[:, None].to(tokens.dtype)
        return torch.stack(drafts, dim=1), torch.stack(dlogits, dim=1)

    return draft_step


def make_speculative_verify_step(cfg: ArchConfig, max_len: int,
                                 page_size: int, k_spec: int,
                                 paged_attn: str = "fused"):
    """Verify half: ONE target forward over ``[t0, d_1..d_K]`` at
    positions ``pos..pos+K`` (-1 past each slot's ``spec_len``): all
    K+1 KV entries are written through the page table and attention runs
    the paged verify kernel (``"gather"``: the dense page gather); then
    the accept rule. Returns (out [B, K+1], n_acc [B]), -1 / 0 on
    inactive slots."""

    def verify_step(params, tokens, draft_tok, draft_lg, cache, positions,
                    active, page_table, spec_len, generator, temperature):
        pos = positions.to(torch.int64).clamp(0, max_len - 1)
        seq = torch.cat([tokens, draft_tok.to(tokens.dtype)], dim=1)
        steps_i = torch.arange(k_spec + 1, device=tokens.device)[None, :]
        qpos = torch.where(steps_i <= spec_len.to(torch.int64)[:, None],
                           pos[:, None] + steps_i, -1)
        logits = forward(
            params, seq, cfg, positions=qpos, cache=cache,
            page_table=page_table, page_size=page_size,
            paged_attn=paged_attn,
        )
        out, n_acc = speculative_accept(logits, draft_tok, draft_lg,
                                        spec_len, generator, temperature)
        out = torch.where(active[:, None], out, -1)
        n_acc = torch.where(active, n_acc, 0)
        return out, n_acc

    return verify_step



# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no memory)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                kv_bits=None) -> dict:
    """Meta-tensor stand-ins for every input of this (arch x shape) cell,
    in the reference's shapes and dtypes (token ids int32, prefix
    embeddings bf16): train ``batch`` (``tokens``, ``targets``); prefill
    ``batch`` (``tokens``) and ``cache``; decode ``tokens`` [B, 1],
    ``cache`` and ``pos`` (0-d int32); train and prefill batches of the
    modality-stub archs carry ``prefix_embeds`` [B, P, D].

    Caches are the port's ``init_cache`` in its list layout for every
    cell. The reference prefills the uniform families into its stacked
    scan-over-layers cache, which keeps XLA's compile time flat in depth;
    eager PyTorch compiles nothing, so the port keeps one layout (a kept
    difference: the same tensors, one per layer)."""
    b, s = shape.global_batch, shape.seq_len
    specs: dict = {}

    def ids(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind == "train":
        specs["batch"] = {"tokens": ids(b, s), "targets": ids(b, s)}
    elif shape.kind == "prefill":
        specs["batch"] = {"tokens": ids(b, s)}
        specs["cache"] = init_cache(cfg, b, s + _prefix_len(cfg),
                                    device="meta")
    elif shape.kind == "decode":
        specs["tokens"] = ids(b, 1)
        specs["cache"] = init_cache(cfg, b, s, kv_bits=kv_bits,
                                    device="meta")
        specs["pos"] = ids()
    if shape.kind in ("train", "prefill") and cfg.n_prefix_embeds:
        specs["batch"]["prefix_embeds"] = torch.empty(
            (b, cfg.n_prefix_embeds, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
    return specs


def _prefix_len(cfg: ArchConfig) -> int:
    return cfg.n_prefix_embeds
