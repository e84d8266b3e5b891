"""Plain reference of a learned-LSH deployment: the SIREN trunk, the
multivariate-Bernoulli code and its best-first flip probes, one bucket
table per head with its probe budget, and the exact cosine rerank.

It is written from the published description of the method and reads
the committed params itself (:mod:`portbench.reference.msgpack`); it
takes nothing the program built.  Everything runs in float32 with TF32
off, or, with ``precision="tf32"``, with every matrix product's operands
rounded to TF32's 10-bit mantissa: the lower precision a program would
be tempted by, which the benchmark's control runs in the program's
place.

Definitions the program is held to:

* a head maps ``x`` through ``sin(w0_initial * (x W0 + b0))``, then
  ``sin(w0 * (h Wi + bi))`` for the hidden layers but the last, which is
  linear, then ``sigmoid(h Wout + bout)``: one probability per bit;
* the hard code sets bit ``j`` where its probability exceeds 0.5 and
  packs the bits most significant first;
* flip probe ``m`` (``m < P``) flips, of the ``ceil(log2 P)`` least
  confident bits (``|p - 0.5|``, the lower bit index first among equal
  confidences), those whose position is set in ``m``; repeated buckets
  are probed once;
* a bucket lists its corpus rows in corpus order; a probe serves its
  first ``budget`` rows (all of them without a budget);
* a query's candidates are the distinct rows its probes serve over all
  tables; ``n_candidates`` is the sum of the probed buckets' full
  counts, each table's distinct probes counted once per table;
* the answer is the ``k`` candidates of highest cosine similarity.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.msgpack import read_msgpack

PRECISIONS = ("float32", "tf32")
HASH_CHUNK = 65_536  # corpus rows hashed per block


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest, ties to even, to TF32's 10-bit
    mantissa: what a tensor core reads of a float32 operand under TF32."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def normalize(x: torch.Tensor) -> torch.Tensor:
    nrm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(nrm, min=1e-12)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``(n, b)`` {0, 1} -> ``(n,)`` int64 bucket ids, first bit highest."""
    b = bits.shape[-1]
    w = 2 ** torch.arange(b - 1, -1, -1, device=bits.device)
    return (bits.long() * w).sum(-1)


def flip_probes(p: torch.Tensor, n_probes: int):
    """Best-first flip probes of bit probabilities ``p (n, b)``:
    ``(ids (n, P) int64 sorted, valid (n, P))``, ``valid`` False on a
    repeated bucket."""
    n, b = p.shape
    n_flip = min(max(math.ceil(math.log2(n_probes)), 1), b) \
        if n_probes > 1 else 1
    base = pack_bits(p > 0.5)
    conf = torch.abs(p - 0.5)
    pos = torch.sort(conf, dim=1, stable=True).indices[:, :n_flip]
    weight = 2 ** (b - 1 - pos)                          # (n, n_flip)
    m = torch.arange(n_probes, device=p.device)
    take = (m[:, None] >> torch.arange(n_flip, device=p.device)) & 1
    xor = (take[None] * weight[:, None, :]).sum(-1)      # (n, P)
    ids = torch.sort(torch.bitwise_xor(base[:, None], xor), dim=1).values
    valid = torch.ones_like(ids, dtype=torch.bool)
    valid[:, 1:] = ids[:, 1:] != ids[:, :-1]
    return ids, valid


class _Head:
    """One table's trunk and output layer, weights as ``(out, in)``."""

    def __init__(self, tree: dict, t: int | None, w0: float,
                 w0_initial: float, device, tf32: bool):
        def leaf(a):
            a = np.array(a if t is None else a[t], np.float32)
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        layers = tree["encoder"]["layers"]
        self.layers = [(leaf(layers[str(i)]["w"]).T.contiguous(),
                        leaf(layers[str(i)]["b"]))
                       for i in range(len(layers))]
        self.out = (leaf(tree["out"]["w"]).T.contiguous(),
                    leaf(tree["out"]["b"]))
        self.w0, self.w0_initial, self.tf32 = w0, w0_initial, tf32
        if tf32:
            self.layers = [(tf32_round(w), b) for w, b in self.layers]
            self.out = (tf32_round(self.out[0]), self.out[1])

    def _linear(self, x, w, b):
        return F.linear(tf32_round(x) if self.tf32 else x, w, b)

    def probs(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, (w, b) in enumerate(self.layers):
            z = self._linear(x, w, b)
            x = z if i == last else torch.sin(
                (self.w0_initial if i == 0 else self.w0) * z)
        return torch.sigmoid(self._linear(x, *self.out))


class Reference:
    """The deployment's tables over ``corpus`` and the exact answers of
    query batches, on ``device``.

    Args:
      params: path of the committed msgpack params (a stacked ensemble's
        under ``"hashing"``, with a leading table axis).
      corpus: ``(n, d)`` float32 numpy rows.
      n_tables: heads in the params (1: not stacked).
      budget: rows served per probed bucket; None serves every row.
      n_probes: flip probes per table.
      w0, w0_initial: the trunk's frequencies.
      precision: ``"float32"`` or ``"tf32"`` (the control).
      block_bytes: the candidate rows one block of queries gathers.
    """

    def __init__(self, params: str, corpus: np.ndarray, *, n_tables: int,
                 budget: int | None, n_probes: int, w0: float = 1.0,
                 w0_initial: float = 30.0, device="cpu",
                 precision: str = "float32", block_bytes: int = 1 << 30):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.tf32 = precision == "tf32"
        tree = read_msgpack(params)
        tree = tree.get("hashing", tree)
        self.heads = [_Head(tree, None if n_tables == 1 else t, w0,
                            w0_initial, self.device, self.tf32)
                      for t in range(n_tables)]
        self.n_probes = n_probes
        self.budget = budget
        self.block_bytes = block_bytes
        x = torch.from_numpy(np.ascontiguousarray(corpus, np.float32))
        self.n, self.d = x.shape
        self.bits = self.heads[0].out[0].shape[0]
        n_buckets = 2 ** self.bits
        orders, starts, counts = [], [], []
        with torch.no_grad():
            for h in self.heads:
                codes = torch.cat([
                    pack_bits(h.probs(x[s:s + HASH_CHUNK].to(self.device))
                              > 0.5)
                    for s in range(0, self.n, HASH_CHUNK)])
                cnt = torch.bincount(codes, minlength=n_buckets)
                orders.append(torch.argsort(codes, stable=True))
                counts.append(cnt)
                starts.append(torch.cumsum(cnt, 0) - cnt)
        self.order = torch.cat(orders)        # table t's at t * n
        self.counts = torch.stack(counts)     # (T, NB)
        self.starts = torch.stack(starts)
        self.rows = normalize(x.to(self.device))
        if self.tf32:
            self.rows = tf32_round(self.rows)
        served = self.counts.max().item() if budget is None else \
            min(budget, self.counts.max().item())
        self.width_bound = n_tables * n_probes * max(served, 1)

    # -- candidates ------------------------------------------------------

    def _block(self) -> int:
        """Queries per block: their candidate rows stay near
        ``block_bytes``."""
        per_query = self.width_bound * self.d * 4
        return int(max(1, min(4096, self.block_bytes // per_query)))

    def probes(self, q: torch.Tensor):
        """``(ids (T, c, P), valid (T, c, P))`` of a block of queries."""
        out = [flip_probes(h.probs(q), self.n_probes) for h in self.heads]
        return (torch.stack([i for i, _ in out]),
                torch.stack([v for _, v in out]))

    def candidates(self, q: torch.Tensor):
        """A block's candidates: ``(rows (c, w) int64, -1 padded, in
        ascending row order per query; n_distinct (c,); n_candidates
        (c,))``."""
        pid, pv = self.probes(q)
        T, c, P = pid.shape
        tix = torch.arange(T, device=q.device)[:, None, None]
        full = torch.where(pv, self.counts[tix, pid], 0)
        n_cand = full.sum((0, 2))
        served = full if self.budget is None else \
            torch.clamp(full, max=self.budget)
        first = self.starts[tix, pid] + tix * self.n
        lengths = served.permute(1, 0, 2).reshape(-1)
        first = first.permute(1, 0, 2).reshape(-1)
        total = int(lengths.sum())
        seg = torch.cumsum(lengths, 0) - lengths
        within = torch.arange(total, device=q.device) - \
            torch.repeat_interleave(seg, lengths)
        rows = self.order[torch.repeat_interleave(first, lengths) + within]
        qix = torch.repeat_interleave(
            torch.arange(c, device=q.device), served.sum((0, 2)))
        keys = torch.unique(qix * self.n + rows)  # sorted, distinct
        qix, rows = keys // self.n, keys % self.n
        n_q = torch.bincount(qix, minlength=c)
        pos = torch.arange(keys.shape[0], device=q.device) - \
            (torch.cumsum(n_q, 0) - n_q)[qix]
        dense = torch.full((c, max(int(n_q.max()), 1)), -1,
                           dtype=torch.int64, device=q.device)
        dense[qix, pos] = rows
        return dense, n_q, n_cand

    def _scores(self, qn: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Cosine similarity of each query with the rows ``ids (c, w)``;
        ``-inf`` where an id is -1."""
        cand = self.rows[ids.clamp(min=0)]
        s = torch.bmm(cand, qn[:, :, None])[..., 0]
        return torch.where(ids >= 0, s, -torch.inf)

    def _qn(self, q: torch.Tensor) -> torch.Tensor:
        qn = normalize(q)
        return tf32_round(qn) if self.tf32 else qn

    # -- answers ---------------------------------------------------------

    @torch.no_grad()
    def answer(self, queries: np.ndarray, k: int):
        """The exact answers of a batch: ``(ids (nq, k) int64, -1
        padded; n_candidates (nq,))`` as numpy."""
        ids, n_cand = [], []
        for s in range(0, queries.shape[0], self._block()):
            q = torch.from_numpy(queries[s:s + self._block()]).to(self.device)
            dense, _, nc = self.candidates(q)
            sc = self._scores(self._qn(q), dense)
            kk = min(k, sc.shape[1])
            top, arg = torch.topk(sc, kk, dim=1)
            got = torch.where(torch.isfinite(top), dense.gather(1, arg), -1)
            ids.append(F.pad(got, (0, k - kk), value=-1).cpu())
            n_cand.append(nc.cpu())
        return torch.cat(ids).numpy(), torch.cat(n_cand).numpy()

    @torch.no_grad()
    def judge(self, queries: np.ndarray, ids: np.ndarray,
              n_cand: np.ndarray) -> dict:
        """Hold a program's answers ``(ids (nq, k), n_cand (nq,))`` to the
        exact ones.  Per query: ``count_ok`` (its ``n_candidates`` equals
        the reference's), ``foreign`` (its ids that are no candidate of
        the query, repeats included), and ``gap``: the widest amount by
        which the program's ``j``-th best score lies below the
        reference's ``j``-th, both scored here (a repeated or missing id
        scores ``-inf``)."""
        k = ids.shape[1]
        out = {"count_ok": [], "foreign": [], "gap": []}
        for s in range(0, queries.shape[0], self._block()):
            q = torch.from_numpy(queries[s:s + self._block()]).to(self.device)
            c = q.shape[0]
            dense, _, nc = self.candidates(q)
            qn = self._qn(q)
            ref = self._scores(qn, dense)
            kk = min(k, ref.shape[1])
            ref_top = F.pad(torch.topk(ref, kk, dim=1).values,
                            (0, k - kk), value=-torch.inf)
            got = torch.from_numpy(
                np.ascontiguousarray(ids[s:s + c], np.int64)).to(self.device)
            bad = (got < -1) | (got >= self.n)
            got = torch.where(bad, self.n, got)
            srt, order = torch.sort(got, dim=1)
            rep = torch.zeros_like(srt, dtype=torch.bool)
            rep[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
            rep = torch.zeros_like(rep).scatter_(1, order, rep)
            keyed = torch.where(dense >= 0, dense, self.n + 1)
            at = torch.searchsorted(keyed, got.clamp(min=0, max=self.n))
            at = at.clamp(max=keyed.shape[1] - 1)
            member = keyed.gather(1, at) == got
            real = got >= 0
            mine = self._scores(qn, torch.where(real & ~bad, got, -1))
            mine = torch.where(rep | bad, -torch.inf, mine)
            mine = torch.sort(mine, dim=1, descending=True).values
            gap = torch.where(torch.isfinite(ref_top), ref_top - mine,
                              torch.zeros_like(mine))
            gap = torch.nan_to_num(gap, nan=0.0, posinf=torch.inf)
            out["count_ok"].append((nc.cpu().numpy() == n_cand[s:s + c]))
            out["foreign"].append(
                ((real & ~member) | rep | bad).sum(1).cpu().numpy())
            out["gap"].append(gap.max(1).values.cpu().numpy())
        return {key: np.concatenate(v) for key, v in out.items()}

    @torch.no_grad()
    def work(self, queries: np.ndarray):
        """What a batch's candidates require: ``(pairs, rows)``, the
        distinct (query, candidate) pairs and the distinct candidate rows
        of the whole batch."""
        pairs = 0
        seen = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        for s in range(0, queries.shape[0], self._block()):
            q = torch.from_numpy(queries[s:s + self._block()]).to(self.device)
            dense, n_q, _ = self.candidates(q)
            pairs += int(n_q.sum())
            seen[dense[dense >= 0]] = True
        return pairs, int(seen.sum())

    @torch.no_grad()
    def exact_topk(self, queries: np.ndarray, k: int,
                   block: int = 256) -> np.ndarray:
        """The exact top ``k`` over the whole corpus (brute force), for
        the record of a batch's recall."""
        out = []
        for s in range(0, queries.shape[0], block):
            q = torch.from_numpy(queries[s:s + block]).to(self.device)
            sc = self._qn(q) @ self.rows.T
            out.append(torch.topk(sc, k, dim=1).indices.cpu())
        return torch.cat(out).numpy()
