"""The plain reference of M3P: forward, losses and Adam in float32 torch.

It follows the published model (M3P, arXiv:2006.02635, over XLM-R base):
post-LN encoder blocks over the [regions; text] concatenation, positions
over the whole concatenation, a 3-layer attention-on-attention refiner
over the region embeddings, the tied word head, the object, ITM and MRFR
heads.  It imports nothing of the program: it takes the benchmark's
weights (a dict of tensors by name) and inputs, and draws again, from a
seed, the randomness that the configuration states (masking, dropout and
attention dropout) by the rules written out below, so that it drops and
masks what the program drops and masks.  Every tensor it computes with is
float32, with TF32 off; no kernel, cache or fused path.

Two departures, both the rules of the JAX model that M3P's port follows:
the kept values of an elementwise dropout are divided by 1 - rate held in
the configuration's compute dtype (flax divides by a weak float in the
input's dtype), and the masks of that dropout are drawn as a bernoulli
tensor in the compute dtype.

Rows are processed in blocks so that a full-size batch fits: the losses'
denominators and the packing of prediction slots are taken over the
whole batch first, and each block's share of the loss is back-propagated
on its own.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.philox import attention_keep

LN_EPS = 1e-12
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
PAD = 1
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def ffn_dim(cfg: dict) -> int:
    return cfg["hidden_dim"] or 4 * cfg["emb_dim"]


# ---------------------------------------------------------------------------
# the parameters
# ---------------------------------------------------------------------------

def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter, sorted by name.  ``kind``:
    "dense" (a (out, in) matrix), "bias", "ln_w", "ln_b", "embed"."""
    d, h, f = cfg["emb_dim"], ffn_dim(cfg), cfg["img_feat_dim"]
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def dense(name, n_out, n_in, bias=True):
        out.append((f"{name}.weight", (n_out, n_in), "dense"))
        if bias:
            out.append((f"{name}.bias", (n_out,), "bias"))

    def ln(name):
        out.append((f"{name}.weight", (d,), "ln_w"))
        out.append((f"{name}.bias", (d,), "ln_b"))

    out.append(("text_emb.word.weight", (cfg["n_words"], d), "embed"))
    out.append(("text_emb.position.weight", (cfg["max_positions"], d),
                "embed"))
    out.append(("text_emb.lang.weight", (cfg["n_langs"], d), "embed"))
    ln("text_emb.ln_emb")
    dense("image_emb.img_proj", d, f)
    dense("image_emb.loc_proj", d, cfg["img_loc_dim"])
    ln("image_emb.ln")
    for i in range(cfg["refine_layers"]):
        p = f"refiner.layer_{i}"
        ln(f"{p}.ln_attn")
        for lin in ("q_lin", "k_lin", "v_lin"):
            dense(f"{p}.aoa_attn.{lin}", d, d)
        dense(f"{p}.aoa_attn.aoa", 2 * d, 2 * d)
        ln(f"{p}.ln_ffn")
        dense(f"{p}.ffn.lin1", h, d)
        dense(f"{p}.ffn.lin2", d, h)
    ln("refiner.ln_out")
    for i in range(cfg["n_layers"]):
        p = f"block_{i}"
        for att in ("attn", "encoder_attn"):
            for lin in ("q_lin", "k_lin", "v_lin", "out_lin"):
                dense(f"{p}.{att}.{lin}", d, d)
        ln(f"{p}.ln1")
        ln(f"{p}.ln15")
        dense(f"{p}.ffn.lin1", h, d)
        dense(f"{p}.ffn.lin2", d, h)
        ln(f"{p}.ln2")
    out.append(("pred_layer.bias", (cfg["n_words"],), "bias"))
    dense("obj_pred.transform_dense", d, d)
    ln("obj_pred.transform_ln")
    dense("obj_pred.proj", cfg["n_obj_classes"], d)
    for pool in ("itm_pooler", "clcm_pooler"):
        dense(f"{pool}.dense", d, d)
        dense(f"{pool}.score", 1, d)
    dense("mrfr_head.dense", f, d)
    return sorted(out)


# ---------------------------------------------------------------------------
# the randomness of a training step, drawn again
# ---------------------------------------------------------------------------

class StepDraws:
    """The generators of a training step: ``device`` draws masking and
    elementwise dropout masks, ``host`` the per-call attention seeds, as
    the configuration's training step draws them (seeded ``seed`` and
    ``seed + 1``)."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.Generator(device=device)
        self.device.manual_seed(seed)
        self.host = torch.Generator()
        self.host.manual_seed(seed + 1)

    def seed(self) -> int:
        return int(torch.randint(0, 2 ** 63 - 1, (), generator=self.host))

    def keep(self, shape, rate: float, dtype, device) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.bernoulli_(1.0 - rate, generator=self.device).bool()


def select_fixed(gen: torch.Generator, eligible: torch.Tensor, rate: float,
                 max_pred: int):
    """Bernoulli(rate) over eligible positions, the selected ones first in
    the order of a random priority, into min(max_pred, S) fixed slots:
    (positions (B, P), weights (B, P))."""
    b, s = eligible.shape
    p = min(max_pred, s)
    dev = eligible.device
    selected = (torch.rand((b, s), generator=gen, device=dev) < rate) \
        & eligible
    prio = torch.rand((b, s), generator=gen, device=dev)
    score = torch.where(selected, 1.0 + prio, prio * 1e-3)
    top, positions = torch.topk(score, p, dim=1)
    return positions, (top >= 1.0).float()


def mask_words(gen: torch.Generator, tokens: torch.Tensor,
               valid: torch.Tensor, mk: dict):
    """80/10/10 word masking over fixed slots: (masked tokens, positions,
    labels, weights); the BOS and pads are never chosen; with nothing
    chosen in the whole batch, slot 0 of row 0 predicts position 1."""
    b, s = tokens.shape
    dev = tokens.device
    eligible = valid.bool() & (tokens != PAD)
    eligible[:, 0] = False
    positions, weights = select_fixed(gen, eligible, mk["word_pred"],
                                      mk["max_pred"])
    n = positions.shape[1]
    first = ((torch.arange(b, device=dev) == 0)[:, None]
             & (torch.arange(n, device=dev) == 0)[None, :])
    force = first & (weights.sum() == 0)
    positions = torch.where(force, 1, positions)
    weights = torch.where(force, 1.0, weights)
    labels = tokens.gather(1, positions)
    u = torch.rand((b, n), generator=gen, device=dev)
    words = torch.randint(4, mk["n_words"], (b, n), generator=gen,
                          device=dev, dtype=tokens.dtype)
    p_mask, p_rand = mk["mask_rate"], mk["rand_rate"]
    replaced = torch.where(u < p_mask,
                           torch.full_like(labels, mk["mask_index"]),
                           torch.where(u < p_mask + p_rand, words, labels))
    replaced = torch.where(weights > 0, replaced, labels)
    return tokens.clone().scatter_(1, positions, replaced), positions, \
        labels, weights


def mask_objects(gen: torch.Generator, feats: torch.Tensor,
                 obj_labels: torch.Tensor, img_mask: torch.Tensor, mk: dict):
    """Zero ~15% of the valid regions' features: (masked feats, positions,
    labels, weights, target feats)."""
    positions, weights = select_fixed(gen, img_mask.bool(), mk["obj_pred"],
                                      mk["max_pred"])
    labels = obj_labels.gather(1, positions)
    index = positions[..., None].expand(-1, -1, feats.shape[-1])
    target = feats.gather(1, index)
    zero = torch.zeros(feats.shape[:2], dtype=feats.dtype,
                       device=feats.device)
    zero = zero.scatter(1, positions, weights.to(feats.dtype))
    return feats * (1.0 - zero)[..., None], positions, labels, weights, \
        target


def packed(weights: torch.Tensor, budget: int) -> torch.Tensor:
    """Which flat slots of ``weights`` (B, P) the loss keeps: the
    ``budget`` largest, equal weights lower index first; bool (B, P)."""
    flat = weights.reshape(-1)
    _, idx = torch.sort(flat, descending=True, stable=True)
    keep = torch.zeros_like(flat, dtype=torch.bool)
    keep[idx[:budget]] = True
    return keep.view(weights.shape) & (weights > 0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Masks:
    """The elementwise dropout masks of one forward over the whole batch,
    in the order the forward takes them, read back block by block."""

    def __init__(self, masks: Optional[List[torch.Tensor]],
                 seeds: Optional[List[int]]):
        self.masks, self.seeds = masks, seeds
        self.rows: Optional[torch.Tensor] = None
        self.i = self.j = 0

    def start(self, rows: torch.Tensor) -> "Masks":
        self.rows, self.i, self.j = rows, 0, 0
        return self

    def next_mask(self) -> Optional[torch.Tensor]:
        if self.masks is None:
            return None
        m = self.masks[self.i]
        self.i += 1
        return m.index_select(0, self.rows)

    def next_seed(self) -> Optional[int]:
        if self.seeds is None:
            return None
        s = self.seeds[self.j]
        self.j += 1
        return s


class PlainM3P:
    """The float32 forward of M3P over a dict of parameters."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor]):
        self.cfg = cfg
        self.p = params
        self.d = cfg["emb_dim"]
        self.h = cfg["n_heads"]
        self.rate = cfg["dropout"]
        self.att_rate = cfg["attention_dropout"]
        # flax's dropout scale: 1 - rate in the compute dtype
        cd = DTYPES[cfg["dtype"]]
        self.keep_prob = float(torch.tensor(1.0 - self.rate, dtype=cd))
        self.query_chunk = 1024

    # -- pieces -------------------------------------------------------------
    def lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.p[f"{name}.weight"], self.p.get(
            f"{name}.bias"))

    def ln(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], LN_EPS)

    def drop(self, x: torch.Tensor, masks: Masks) -> torch.Tensor:
        keep = masks.next_mask()
        if keep is None:
            return x
        return torch.where(keep, x / self.keep_prob, 0.0)

    def attention(self, q, k, v, kv_mask, masks: Masks) -> torch.Tensor:
        """Scaled dot-product attention over (b, S, H*Dh), the keys masked
        by ``kv_mask``; with a seed the attention weights are dropped by
        the Philox rule of tile (batch row, head) and scaled by
        1 / (1 - rate)."""
        b, s, d = q.shape
        h, dh = self.h, d // self.h
        qh = q.view(b, s, h, dh).transpose(1, 2)
        kh = k.view(b, -1, h, dh).transpose(1, 2)
        vh = v.view(b, -1, h, dh).transpose(1, 2)
        sk = kh.shape[2]
        seed = masks.next_seed()
        outs = []
        for q0 in range(0, s, self.query_chunk):
            q1 = min(s, q0 + self.query_chunk)
            scores = qh[:, :, q0:q1] @ kh.transpose(-1, -2) / math.sqrt(dh)
            scores = scores.masked_fill(~kv_mask[:, None, None, :].bool(),
                                        MASK_VALUE)
            p = torch.softmax(scores, dim=-1)
            if seed is not None:
                keep = attention_keep(seed, masks.rows, h, q0, q1, sk,
                                      self.att_rate)
                p = p.masked_fill(~keep, 0.0) * (1.0 / (1.0 - self.att_rate))
            outs.append(p @ vh)
        ctx = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
        return ctx.transpose(1, 2).reshape(b, s, d)

    def ffn(self, name: str, x: torch.Tensor, masks: Masks) -> torch.Tensor:
        y = self.lin(f"{name}.lin2", F.gelu(self.lin(f"{name}.lin1", x)))
        return self.drop(y, masks)

    def block(self, i: int, x: torch.Tensor, pad: torch.Tensor,
              masks: Masks) -> torch.Tensor:
        p = f"block_{i}"
        a = self.attention(self.lin(f"{p}.attn.q_lin", x),
                           self.lin(f"{p}.attn.k_lin", x),
                           self.lin(f"{p}.attn.v_lin", x), pad, masks)
        a = self.lin(f"{p}.attn.out_lin", a)
        x = self.ln(f"{p}.ln1", x + self.drop(a, masks))
        x = self.ln(f"{p}.ln2", x + self.ffn(f"{p}.ffn", x, masks))
        return x * pad[..., None].float()

    def refiner(self, x: torch.Tensor, pad: torch.Tensor,
                masks: Masks) -> torch.Tensor:
        for i in range(self.cfg["refine_layers"]):
            p = f"refiner.layer_{i}"
            y = self.ln(f"{p}.ln_attn", x)
            ctx = self.attention(self.lin(f"{p}.aoa_attn.q_lin", y),
                                 self.lin(f"{p}.aoa_attn.k_lin", y),
                                 self.lin(f"{p}.aoa_attn.v_lin", y), pad,
                                 masks)
            gate_in = self.drop(torch.cat([ctx, y], dim=-1), masks)
            a, g = self.lin(f"{p}.aoa_attn.aoa", gate_in).chunk(2, dim=-1)
            x = x + self.drop(a * torch.sigmoid(g), masks)
            x = x + self.drop(self.ffn(f"{p}.ffn", self.ln(f"{p}.ln_ffn", x),
                                       masks), masks)
        return self.ln("refiner.ln_out", x)

    def stack(self, x, pad, masks: Masks):
        for i in range(self.cfg["n_layers"]):
            x = self.block(i, x, pad, masks)
        return x

    # -- encoders -------------------------------------------------------------
    def encode_joint(self, tokens, text_mask, feats, locs, img_mask,
                     masks: Masks) -> torch.Tensor:
        """[regions; text] -> (b, R + S, D): region embeddings (projections,
        LN, dropout), the padding zeroed, the refiner; word embeddings;
        positions over the concatenation; LN, dropout; the blocks."""
        img = self.lin("image_emb.img_proj", feats) \
            + self.lin("image_emb.loc_proj", locs)
        img = self.drop(self.ln("image_emb.ln", img), masks)
        img = img * img_mask[..., None].float()
        img = self.refiner(img, img_mask, masks)
        txt = F.embedding(tokens, self.p["text_emb.word.weight"])
        x = torch.cat([img, txt], dim=1)
        x = x + self.p["text_emb.position.weight"][:x.shape[1]][None]
        pad = torch.cat([img_mask, text_mask], dim=1)
        x = x * pad[..., None].float()
        x = self.drop(self.ln("text_emb.ln_emb", x), masks)
        return self.stack(x, pad, masks)

    def encode_text(self, tokens, text_mask, masks: Masks) -> torch.Tensor:
        x = F.embedding(tokens, self.p["text_emb.word.weight"])
        x = x + self.p["text_emb.position.weight"][:tokens.shape[1]][None]
        x = self.drop(self.ln("text_emb.ln_emb", x), masks)
        x = x * text_mask[..., None].float()
        return self.stack(x, text_mask, masks)

    # -- heads ---------------------------------------------------------------
    def word_logits(self, h):
        return F.linear(h, self.p["text_emb.word.weight"],
                        self.p["pred_layer.bias"])

    def obj_logits(self, h):
        h = F.gelu(self.lin("obj_pred.transform_dense", h))
        return self.lin("obj_pred.proj", self.ln("obj_pred.transform_ln", h))

    def itm_score(self, hidden):
        h = torch.tanh(self.lin("itm_pooler.dense", hidden[:, 0]))
        return self.lin("itm_pooler.score", h)[:, 0]

    def mrfr(self, h):
        return self.lin("mrfr_head.dense", h)


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

def draw_forward(cfg: dict, draws: StepDraws, shapes: Sequence[tuple],
                 n_seeds: int, device) -> Masks:
    """A forward's elementwise masks (full-batch ``shapes``, drawn on the
    device in call order) and its ``n_seeds`` attention seeds (drawn on
    the host in call order); the two generators are independent, so each
    list is drawn whole."""
    cd = DTYPES[cfg["dtype"]]
    rate = cfg["dropout"]
    masks = seeds = None
    if rate > 0:
        masks = [draws.keep(s, rate, cd, device) for s in shapes]
    if cfg["attention_dropout"] > 0:
        seeds = [draws.seed() for _ in range(n_seeds)]
    return Masks(masks, seeds)


def joint_mask_shapes(cfg: dict, bn: int, r: int, s: int) -> List[tuple]:
    d = cfg["emb_dim"]
    shapes = [(bn, r, d)]
    for _ in range(cfg["refine_layers"]):
        shapes += [(bn, r, 2 * d), (bn, r, d), (bn, r, d), (bn, r, d)]
    shapes.append((bn, r + s, d))
    for _ in range(cfg["n_layers"]):
        shapes += [(bn, r + s, d), (bn, r + s, d)]
    return shapes


class Adam:
    """clip_by_global_norm(clip) -> Adam with bias correction and the
    inverse-square-root schedule with linear warm-up, in float32."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict):
        self.opt = opt
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def lr(self, step: int) -> float:
        o = self.opt
        step = max(step, 1)
        if step < o["warmup_updates"]:
            return o["warmup_init_lr"] + step * (o["lr"] - o["warmup_init_lr"]
                                                 ) / o["warmup_updates"]
        return o["lr"] * o["warmup_updates"] ** 0.5 * step ** -0.5

    @torch.no_grad()
    def step(self, params, grads) -> Dict[str, torch.Tensor]:
        """Update ``params`` in place; returns the clipped gradients."""
        o = self.opt
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = min(1.0, o["clip"] / float(norm)) if o["clip"] else 1.0
        clipped = {k: g * scale for k, g in grads.items()}
        lr = self.lr(self.t)
        self.t += 1
        b1, b2 = o["beta1"], o["beta2"]
        for k, g in clipped.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mh = self.m[k] / (1 - b1 ** self.t)
            vh = self.v[k] / (1 - b2 ** self.t)
            params[k].sub_(lr * mh / (vh.sqrt() + o["eps"]))
        return clipped


def _block_rows(n: int, block: int, device) -> Iterator[torch.Tensor]:
    for r0 in range(0, n, block):
        yield torch.arange(r0, min(n, r0 + block), device=device)


def mct_step(cfg: dict, params: Dict[str, torch.Tensor], batch: dict,
             draws: StepDraws, mk: dict, sample_n: int, pack_ratio: float,
             block: int) -> Tuple[float, Dict[str, torch.Tensor]]:
    """One MCT step's loss (ITM CE + BCE, MC-MLM, MC-MRM, MRFR) and its
    float32 gradients, rows in blocks of ``block`` (a multiple of
    ``sample_n``)."""
    dev = batch["tokens"].device
    tokens = batch["tokens"].long()
    feats = batch["feats"].float()
    bn, s = tokens.shape
    r, d = feats.shape[1], cfg["emb_dim"]
    ar = torch.arange
    text_mask = ar(s, device=dev)[None] < batch["text_len"][:, None]
    img_mask = ar(r, device=dev)[None] < batch["img_len"][:, None]
    with torch.no_grad():
        coin = (torch.rand((bn,), generator=draws.device, device=dev)
                < 0.5).float()
        masked_t, pos_t, lab_t, w_t = mask_words(draws.device, tokens,
                                                 text_mask, mk)
        masked_f, pos_r, lab_r, w_r, tgt_r = mask_objects(
            draws.device, feats, batch["obj_labels"].long(), img_mask, mk)
        masks = draw_forward(cfg, draws, joint_mask_shapes(cfg, bn, r, s),
                             cfg["refine_layers"] + cfg["n_layers"], dev)
        w_t = w_t * coin[:, None]
        w_r = w_r * (1.0 - coin)[:, None]
        in_tokens = torch.where(coin[:, None] > 0, masked_t, tokens)
        in_feats = torch.where((coin < 1)[:, None, None], masked_f, feats)
        sel_t = packed(w_t, max(int(w_t.numel() * pack_ratio), 1))
        sel_r = packed(w_r, max(w_r.numel() // 2, 1))
        den_t = (w_t * sel_t).sum()
        den_r = (w_r * sel_r).sum()
        den_obj = (w_r * sel_r * (lab_r >= 0)).sum()
        n_groups = bn // sample_n
    model = PlainM3P(cfg, params)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    total = 0.0
    for rows in _block_rows(bn, block, dev):
        for v in params.values():
            v.grad = None
        hidden = model.encode_joint(
            in_tokens[rows], text_mask[rows], in_feats[rows],
            batch["locs"][rows].float(), img_mask[rows], masks.start(rows))
        img_out, txt_out = hidden[:, :r], hidden[:, r:]
        # MC-MLM over the kept word slots
        st = sel_t[rows]
        gt = txt_out.gather(1, pos_t[rows][..., None].expand(-1, -1, d))[st]
        ce = F.cross_entropy(model.word_logits(gt), lab_t[rows][st].clamp_min(
            0), reduction="none")
        mlm = (ce * w_t[rows][st]).sum() / den_t
        # MC-MRM and MRFR over the kept region slots
        sr = sel_r[rows]
        gr = img_out.gather(1, pos_r[rows][..., None].expand(-1, -1, d))[sr]
        wr = w_r[rows][sr]
        lr_ = lab_r[rows][sr]
        ce_o = F.cross_entropy(model.obj_logits(gr), lr_.clamp_min(0),
                               reduction="none")
        mrm = (ce_o * wr * (lr_ >= 0)).sum() / den_obj
        se = ((model.mrfr(gr) - tgt_r[rows][sr]) ** 2).mean(dim=-1)
        mrfr = (se * wr).sum() / den_r
        # ITM over the candidate grids of the block
        grid = model.itm_score(hidden).view(-1, sample_n)
        pos = batch["pos_label"][rows[::sample_n] // sample_n].long()
        ce_g = F.cross_entropy(grid, pos, reduction="sum") / n_groups
        bce = F.binary_cross_entropy_with_logits(
            grid, F.one_hot(pos, sample_n).float(), reduction="sum") \
            / (n_groups * sample_n)
        loss = ce_g + bce + mlm + mrm + mrfr
        loss.backward()
        total += float(loss.detach())
        for k, v in params.items():
            if v.grad is not None:
                grads[k] += v.grad
    for v in params.values():
        v.grad = None
    return total, grads


def mlm_step(cfg: dict, params: Dict[str, torch.Tensor], batch: dict,
             draws: StepDraws, mk: dict, block: int
             ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """One xMLM step's loss (the mean CE over the masked word slots) and
    its float32 gradients, rows in blocks of ``block``."""
    dev = batch["tokens"].device
    tokens = batch["tokens"].long()
    b, s = tokens.shape
    d = cfg["emb_dim"]
    text_mask = torch.arange(s, device=dev)[None] < batch["lengths"][:, None]
    with torch.no_grad():
        masked, pos, lab, w = mask_words(draws.device, tokens, text_mask, mk)
        shapes = [(b, s, d)] + [(b, s, d)] * (2 * cfg["n_layers"])
        masks = draw_forward(cfg, draws, shapes, cfg["n_layers"], dev)
        den = w.sum()
    model = PlainM3P(cfg, params)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    total = 0.0
    for rows in _block_rows(b, block, dev):
        for v in params.values():
            v.grad = None
        hidden = model.encode_text(masked[rows], text_mask[rows],
                                   masks.start(rows))
        g = hidden.gather(1, pos[rows][..., None].expand(-1, -1, d))
        ce = F.cross_entropy(model.word_logits(g).flatten(0, 1),
                             lab[rows].flatten().clamp_min(0),
                             reduction="none")
        loss = (ce * w[rows].flatten()).sum() / den
        loss.backward()
        total += float(loss.detach())
        for k, v in params.items():
            if v.grad is not None:
                grads[k] += v.grad
    for v in params.values():
        v.grad = None
    return total, grads
