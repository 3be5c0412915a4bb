"""Batched CRUSH mapping in PyTorch — the port of
``ceph_tpu.crush.jax_mapper.BatchMapper``.

The PG batch is the vector axis.  Each straw2 level of a descent is one
launch of the K7 kernel (``straw2.straw2_choose``, ``csrc/crush_straw2.cu``)
over the lanes that still descend; the retry loops are masked loops
that shrink to the lanes still unplaced, so a round costs what its
stragglers need.  The legacy bucket algorithms (uniform, list, tree,
straw) are torch code beside it.  Output is bit-identical to the scalar
oracle (``mapper.do_rule``) and to ``ceph_tpu``'s mapper
(``tests/test_torch_crush.py``).

Supported: every bucket algorithm, rules of one or more ``take →
[set_*] → choose-chain → emit`` blocks including multi-step firstn
chains, every chooseleaf vary_r/stable combination, choose_args
weight-sets and id substitution, and reweights.  Refused with
``NotImplementedError``, where ``ceph_tpu`` refuses: choose_local
(_fallback)_tries > 0, chooseleaf mid-chain, indep inside a multi-step
chain, indep or a chooseless block in a multi-block rule.

Not carried over from ``ceph_tpu``: the XLA compile and its export
cache (torch runs eagerly; ``cache_hit`` stays ``False``), the per-level
size bounds that trimmed traced shapes, the one-hot crush_ln and
magic-number divide (TPU workarounds, see ``csrc/crush_straw2.cu``), and
the candidate-precompute firstn fast path (a scheduling device for
static shapes: here the loops run only on the lanes still active).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device_profiler import DeviceProfiler
from ..utils.device import resolve_device
from . import straw2 as K7
from .map import CRUSH_ITEM_NONE, CrushMap, Rule
from .mapper import _tree_node_weights, calc_straw_scalers

_NONE = CRUSH_ITEM_NONE
_UNDEF = -0x7FFFFFFE
_ALG_CODE = {"straw2": 0, "straw": 1, "list": 2, "tree": 3, "uniform": 4}
# bytes of lane intermediates one chunk of a call may hold
CHUNK_BYTES = 2 << 30


class BatchMapper:
    """One CRUSH rule as a batched ``xs → placements`` function.

    ``__call__(xs[n], reweight[max_devices]?) → np.int32 [n,
    result_max]``: firstn results are compacted with CRUSH_ITEM_NONE
    padding at the end, indep results keep positional NONE holes (EC
    shard order).  ``device=None`` maps on the card.  ``chunk`` caps
    the PGs mapped at once; by default it follows from a budget of
    ``CHUNK_BYTES`` of lane intermediates.

    ``_straw2`` is the straw2 choose every level runs: K7
    (``straw2.straw2_choose``), or its plain version
    (``straw2.straw2_plain``) when a check sets it so on the card."""

    def __init__(self, cmap: CrushMap, rule: Rule | int,
                 result_max: int | None = None, chunk: int | None = None,
                 device=None):
        if isinstance(rule, int):
            rule = cmap.rule_by_id(rule)
        self.cmap = cmap
        self.rule = rule
        self.chunk = chunk
        self.device = resolve_device(device)
        self._straw2 = K7.straw2_choose
        self.cache_hit = False      # nothing is compiled ahead
        t = cmap.tunables

        # multi-block rules (take ... emit, take ... emit): each block
        # maps as its own single-block mapper, outputs concatenate
        self._subs = None
        blocks = self._split_blocks(rule.steps)
        if len(blocks) > 1:
            self._init_multiblock(blocks, result_max)
            return

        # the rule VM (reference crush_do_rule): take + a chain of
        # choose steps + emit; set_* steps override the tunables for
        # the steps that follow
        take = None
        chain: list[dict] = []
        tries = t.choose_total_tries
        leaf_tries = 0
        vary_r = t.chooseleaf_vary_r
        stable = t.chooseleaf_stable
        local_tries = t.choose_local_tries
        local_fb = t.choose_local_fallback_tries
        emitted = False
        for s in rule.steps:
            if s.op == "take":
                if take is not None or emitted:
                    raise NotImplementedError(
                        "multiple take/emit blocks: use the scalar "
                        "oracle")
                take = s.arg1
            elif s.op == "set_choose_tries":
                tries = s.arg1 if s.arg1 > 0 else tries
            elif s.op == "set_chooseleaf_tries":
                leaf_tries = s.arg1 if s.arg1 > 0 else leaf_tries
            elif s.op == "set_chooseleaf_vary_r":
                vary_r = s.arg1 if s.arg1 >= 0 else vary_r
            elif s.op == "set_chooseleaf_stable":
                stable = s.arg1 if s.arg1 >= 0 else stable
            elif s.op == "set_choose_local_tries":
                local_tries = s.arg1 if s.arg1 >= 0 else local_tries
            elif s.op == "set_choose_local_fallback_tries":
                local_fb = s.arg1 if s.arg1 >= 0 else local_fb
            elif s.op in ("choose_firstn", "chooseleaf_firstn",
                          "choose_indep", "chooseleaf_indep"):
                chain.append({
                    "numrep": s.arg1, "target": s.arg2,
                    "firstn": s.op.endswith("firstn"),
                    "leaf": s.op.startswith("chooseleaf"),
                    "tries": tries, "leaf_tries": leaf_tries,
                    "vary_r": vary_r, "stable": stable,
                })
            elif s.op == "emit":
                emitted = True
            else:
                raise NotImplementedError(f"rule step {s.op}: use the oracle")
        if take is None or not chain:
            raise ValueError("rule must contain take and a choose step")
        if local_tries or local_fb:
            raise NotImplementedError(
                "choose_local(_fallback)_tries: use the scalar oracle")
        if any(st["leaf"] for st in chain[:-1]):
            raise NotImplementedError(
                "chooseleaf mid-chain: use the scalar oracle")
        if len(chain) > 1 and not all(st["firstn"] for st in chain):
            raise NotImplementedError(
                "indep in a multi-step chain: use the scalar oracle")

        choose = chain[-1]
        self.firstn = choose["firstn"]
        numrep = choose["numrep"]
        if result_max is None:
            if numrep <= 0:
                raise ValueError("numrep<=0 rule needs explicit result_max")
            result_max = numrep
            for st in chain[:-1]:
                if st["numrep"] <= 0:
                    raise ValueError(
                        "numrep<=0 chain needs explicit result_max")
                result_max *= st["numrep"]
        self.result_max = result_max
        for st in chain:
            n = st["numrep"]
            st["reps"] = n + result_max if n <= 0 else n
            if st["firstn"]:
                st["rtries"] = (st["leaf_tries"] if st["leaf_tries"]
                                else (1 if t.chooseleaf_descend_once
                                      else st["tries"]))
            else:
                st["rtries"] = st["leaf_tries"] or 1
        self.chain = chain
        self.take = take
        self._install_static(self._flatten_static(cmap))
        self._set_weight_tables(cmap)

    # -- tables -------------------------------------------------------------

    def _flatten_static(self, cmap: CrushMap) -> dict:
        """Topology tables: items, sizes, types, algorithms, tree
        shapes.  ``set_weights`` requires these unchanged."""
        nb = len(cmap.buckets)
        S = 1
        for b in cmap.buckets:
            if b is None:
                continue
            if b.alg not in _ALG_CODE:
                raise NotImplementedError(
                    f"bucket alg {b.alg}: use the scalar oracle")
            if b.size == 0:
                raise ValueError("empty bucket in map")
            S = max(S, b.size)
        # choose_args positions: per-position weight sets
        P = 1
        for arg in cmap.choose_args.values():
            if arg.get("weight_set"):
                P = max(P, len(arg["weight_set"]))
        items = np.zeros((nb, S), dtype=np.int32)
        sizes = np.zeros(nb, dtype=np.int32)
        btype = np.zeros(nb, dtype=np.int32)
        acode = np.zeros(nb, dtype=np.int32)
        bids = np.zeros(nb, dtype=np.int32)
        trees = {row: _tree_node_weights(b)[1]
                 for row, b in enumerate(cmap.buckets)
                 if b is not None and b.alg == "tree"}
        NT = max(trees.values(), default=2)
        troot = np.ones(nb, dtype=np.int32)
        tdepth = 0
        for row, b in enumerate(cmap.buckets):
            if b is None:
                continue
            items[row, :b.size] = b.items
            sizes[row] = b.size
            btype[row] = b.type
            acode[row] = _ALG_CODE[b.alg]
            bids[row] = b.id
            if b.alg == "tree":
                n = trees[row] >> 1
                troot[row] = n
                d = 0
                while n and (n & 1) == 0:
                    d += 1
                    n >>= 1
                tdepth = max(tdepth, d)
        return {
            "nb": nb, "S": S, "P": P, "NT": NT,
            "items": items, "sizes": sizes, "btype": btype,
            "acode": acode, "bids": bids, "troot": troot,
            "tdepth": tdepth,
            "uniform_smax": max(
                (b.size for b in cmap.buckets
                 if b is not None and b.alg == "uniform"), default=0),
            "algs": sorted({b.alg for b in cmap.buckets
                            if b is not None}),
        }

    def _install_static(self, st: dict) -> None:
        self._static = st
        self._nb, self._S, self._P = st["nb"], st["S"], st["P"]
        dev = self.device

        def put(a):
            return torch.from_numpy(a.astype(np.int64)).to(dev)
        self._items_t = put(st["items"])
        self._sizes_t = put(st["sizes"])
        self._btype_t = put(st["btype"])
        self._acode_t = put(st["acode"])
        self._bids_t = put(st["bids"])
        self._troot_t = put(st["troot"])

    def _set_weight_tables(self, cmap: CrushMap) -> None:
        """Weight-derived tables: the ``[P, nb, S]`` weight sets,
        choose_args hash-id substitutions, and the legacy algorithms'
        straw scalers, list prefix sums and tree node weights."""
        nb, S, P = self._nb, self._S, self._P
        hash_ids = np.zeros((nb, S), dtype=np.int32)
        weights = np.zeros((P, nb, S), dtype=np.int64)
        strawsc = np.zeros((nb, S), dtype=np.int64)
        lsums = np.zeros((nb, S), dtype=np.int64)
        tnodes = np.zeros((nb, self._static["NT"]), dtype=np.int64)
        for row, b in enumerate(cmap.buckets):
            if b is None:
                continue
            hash_ids[row, :b.size] = b.items
            arg = cmap.choose_args.get(b.id) or {}
            # choose_args act on straw2 buckets only (the oracle's
            # bucket_straw2_choose is their sole reader)
            ws = arg.get("weight_set") if b.alg == "straw2" else None
            if arg.get("ids") and b.alg == "straw2":
                hash_ids[row, :b.size] = arg["ids"]
            for p in range(P):
                if ws:
                    weights[p, row, :b.size] = ws[min(p, len(ws) - 1)]
                elif len(b.weights) == b.size:
                    weights[p, row, :b.size] = b.weights
                else:
                    # uniform buckets may carry only item_weight
                    weights[p, row, :b.size] = b.item_weight
            if b.alg == "straw":
                strawsc[row, :b.size] = calc_straw_scalers(b.weights)
            elif b.alg == "list":
                lsums[row, :b.size] = np.cumsum(b.weights)
            elif b.alg == "tree":
                nodes, num = _tree_node_weights(b)
                tnodes[row, :num] = nodes
        dev = self.device
        self._tab = K7.Straw2Tables(self._static["items"], hash_ids,
                                    weights, self._static["sizes"], dev)
        self._w0_t = torch.from_numpy(weights[0]).to(dev)
        self._strawsc_t = torch.from_numpy(strawsc).to(dev)
        self._lsums_t = torch.from_numpy(lsums).to(dev)
        self._tnodes_t = torch.from_numpy(tnodes).to(dev)

    def set_weights(self, cmap: CrushMap,
                    _check_rule: bool = True) -> "BatchMapper":
        """Rebind to ``cmap``'s weights.  The topology (bucket ids,
        items, sizes, types, algorithms), rule steps, tunables and
        max_devices must be unchanged, else ValueError (callers such as
        ``OSDMap.batch_mapper`` then build a fresh mapper)."""
        if _check_rule:
            try:
                rule = cmap.rule_by_id(self.rule.id)
            except Exception as e:
                raise ValueError(
                    f"rule {self.rule.id} missing from new map") from e
            if ([(s.op, s.arg1, s.arg2) for s in rule.steps]
                    != [(s.op, s.arg1, s.arg2)
                        for s in self.rule.steps]):
                raise ValueError("rule changed: rebuild the mapper")
        if cmap.tunables != self.cmap.tunables:
            raise ValueError("tunables changed: rebuild the mapper")
        if max(cmap.max_devices, 1) != max(self.cmap.max_devices, 1):
            raise ValueError("max_devices changed: rebuild the mapper")
        if self._subs is not None:
            for sub in self._subs:
                sub.set_weights(cmap, _check_rule=False)
            self.cmap = cmap
            return self
        st, old = self._flatten_static(cmap), self._static
        same = all(
            np.array_equal(st[k], old[k]) if isinstance(st[k], np.ndarray)
            else st[k] == old[k] for k in st)
        if not same:
            raise ValueError("topology changed: rebuild the mapper")
        self.cmap = cmap
        self._set_weight_tables(cmap)
        return self

    def remap(self, new_weights) -> "BatchMapper":
        """Weight-only rebind: a full CrushMap of the same topology, or
        ``{bucket_id: [per-item 16.16 weights]}`` patched onto the
        current map (only the named buckets change)."""
        if isinstance(new_weights, CrushMap):
            return self.set_weights(new_weights)
        by_id = dict(new_weights)
        buckets = []
        for b in self.cmap.buckets:
            if b is not None and b.id in by_id:
                ws = [int(w) for w in by_id.pop(b.id)]
                if len(ws) != b.size:
                    raise ValueError(
                        f"bucket {b.id}: {len(ws)} weights != "
                        f"size {b.size}")
                b = dataclasses.replace(
                    b, weights=ws,
                    item_weight=(ws[0] if b.alg == "uniform"
                                 else b.item_weight))
            buckets.append(b)
        if by_id:
            raise ValueError(f"unknown bucket ids {sorted(by_id)}")
        return self.set_weights(
            dataclasses.replace(self.cmap, buckets=buckets))

    # -- one level, one descent ---------------------------------------------

    def _item_type(self, itm):
        rows = (-1 - itm).clamp(0, self._nb - 1)
        return torch.where(itm < 0, self._btype_t[rows],
                           torch.zeros_like(itm))

    def _choose(self, rows, x, r, pos):
        """The bucket choose of lanes in bucket rows ``rows``: K7 for
        straw2 rows, torch code for the legacy algorithms."""
        out = self._straw2(self._tab, rows, x, r, pos).to(torch.int64)
        if self._static["algs"] != ["straw2"]:
            ac = self._acode_t[rows]
            leg = torch.nonzero(ac != 0).squeeze(1)
            if leg.numel():
                got = self._legacy_choose(rows[leg], x[leg], r[leg],
                                          ac[leg])
                out[leg] = got
        return out

    def _legacy_choose(self, rows, x, r, ac):
        """Reference bucket_straw_choose / bucket_list_choose /
        bucket_tree_choose / bucket_perm_choose for lanes in rows of
        those algorithms (``ac`` their codes)."""
        S = self._S
        its = self._items_t[rows]                      # [b, S]
        bid = self._bids_t[rows]
        cols = torch.arange(S, device=rows.device)
        out = its[:, 0].clone()
        algs = self._static["algs"]
        if "straw" in algs:
            u = K7.hash32_3(x[:, None], its, r[:, None]) & 0xFFFF
            draws = u * self._strawsc_t[rows]
            sel = torch.argmax(draws, dim=1)
            val = its.gather(1, sel[:, None])[:, 0]
            out = torch.where(ac == 1, val, out)
        if "list" in algs:
            # newest→oldest: the first hit from the high end
            h4 = K7.hash32_4(x[:, None], its, r[:, None],
                             bid[:, None]) & 0xFFFF
            sums = self._lsums_t[rows]
            w = (h4 * sums) >> 16
            hit = (sums != 0) & (w < self._w0_t[rows])
            j = torch.argmax(hit.flip(1).to(torch.int8), dim=1)
            idx = torch.where(hit.any(dim=1), S - 1 - j,
                              torch.zeros_like(j))
            val = its.gather(1, idx[:, None])[:, 0]
            out = torch.where(ac == 2, val, out)
        if "tree" in algs:
            n = self._troot_t[rows]
            nod = self._tnodes_t[rows]                 # [b, NT]
            for _ in range(self._static["tdepth"]):
                even = (n & 1) == 0
                wn = nod.gather(1, n[:, None])[:, 0]
                h = K7.hash32_4(x, n, r, bid)
                # (h * wn) >> 32 without overflowing int64 (wn < 2^32)
                t_ = (h * (wn >> 16) + ((h * (wn & 0xFFFF)) >> 16)) >> 16
                half = (n & -n) >> 1
                left = n - half
                wl = nod.gather(1, left[:, None])[:, 0]
                n2 = torch.where(t_ < wl, left, n + half)
                n = torch.where(even, n2, n)
            # an all-zero subtree can land on a padding leaf: clamp to a
            # real item (then rejected by is_out)
            idx = torch.minimum(n >> 1, self._sizes_t[rows] - 1).clamp(
                0, S - 1)
            val = its.gather(1, idx[:, None])[:, 0]
            out = torch.where(ac == 3, val, out)
        if "uniform" in algs:
            # bucket_perm_choose: Fisher-Yates keyed by hash(x, id, step),
            # a pure function of (bucket, x, r)
            size = self._sizes_t[rows]
            pr = r % size
            perm = cols.expand(rows.shape[0], S).clone()
            for p in range(min(S, self._static["uniform_smax"])):
                hp = K7.hash32_3(x, bid, p)
                i = hp % (size - p).clamp(min=1)
                swap = (p <= pr) & (p < size - 1) & (i > 0)
                j = (p + i).clamp(max=S - 1)[:, None]
                colp = perm[:, p].clone()
                colj = perm.gather(1, j)[:, 0]
                perm.scatter_(1, j, torch.where(swap, colp, colj)[:, None])
                perm[:, p] = torch.where(swap, colj, colp)
            idx = perm.gather(1, pr[:, None])
            val = its.gather(1, idx)[:, 0]
            out = torch.where(ac == 4, val, out)
        return out

    def _descend(self, start, x, r, target, pos, indep_ft=None,
                 numrep=0):
        """Walk every lane down from ``start`` until its item's type is
        ``target`` (or a device).  Indep walks recompute r per level
        against each level's bucket (reference crush_choose_indep:
        r + numrep·ftotal, or (numrep+1)·ftotal inside a uniform bucket
        whose size numrep divides) and also return the r of each lane's
        last draw."""
        itm = start.clone()
        r_last = r.clone()
        for _ in range(self._nb + 1):
            isb = itm < 0
            rows = (-1 - itm).clamp(0, self._nb - 1)
            need = isb & (self._btype_t[rows] != target)
            idx = torch.nonzero(need).squeeze(1)
            if idx.numel() == 0:
                break
            rw = rows[idx]
            rl = r[idx]
            if indep_ft is not None:
                udiv = ((self._acode_t[rw] == 4)
                        & (self._sizes_t[rw] % numrep == 0))
                rl = rl + torch.where(udiv, numrep + 1, numrep) \
                    * indep_ft[idx]
                r_last[idx] = rl
            itm[idx] = self._choose(rw, x[idx], rl, pos[idx])
        return itm, r_last

    def _dev_out(self, wdev, itm, x):
        """is_out(): the reweight rejection of a device item."""
        w = wdev[itm.clamp(0, wdev.shape[0] - 1)]
        h = K7.hash32_2(x, itm) & 0xFFFF
        keep = (w >= 0x10000) | ((w > 0) & (h < w))
        return ~keep

    # -- firstn -------------------------------------------------------------

    def _leaf_attempts(self, host, x, r, prev_leafs, wdev, pos, cfg,
                       rep0_leaf=None):
        """Inner chooseleaf: up to ``rtries`` attempts inside ``host``
        (reference nested crush_choose_firstn with parent_r = sub_r; the
        outer output position stays the choose_args position)."""
        vr = cfg["vary_r"]
        sub_r = (r >> (vr - 1)) if vr else torch.zeros_like(r)
        if rep0_leaf is not None:
            sub_r = sub_r + rep0_leaf
        got = torch.zeros_like(host, dtype=torch.bool)
        dead = torch.zeros_like(got)
        leaf = torch.full_like(host, _NONE)
        for ft in range(cfg["rtries"]):
            idx = torch.nonzero(~got & ~dead).squeeze(1)
            if idx.numel() == 0:
                break
            h, xi = host[idx], x[idx]
            cand, _ = self._descend(h, xi, sub_r[idx] + ft, 0, pos[idx])
            valid = (cand >= 0) & (h < 0)
            collide = (prev_leafs[idx] == cand[:, None]).any(dim=1)
            reject = collide | self._dev_out(wdev, cand, xi) | ~valid
            succ = ~reject
            leaf[idx] = torch.where(succ, cand, leaf[idx])
            got[idx] = succ
            dead[idx] = ~valid
        return leaf, got

    def _rep_round(self, x, roots, out, leafs, wdev, active0, rep_eff,
                   pos, cfg):
        """One firstn rep (reference crush_choose_firstn's retry_descent
        loop): every lane retries with r = rep + ftotal until it places
        an item, finds a dead end, or spends ``tries``."""
        step_leaf = cfg["leaf"] and cfg["target"] != 0
        target = cfg["target"]
        B = x.shape[0]
        ftotal = torch.zeros(B, dtype=torch.int64, device=x.device)
        placed = ~active0
        dead = torch.zeros_like(placed)
        item = torch.full_like(roots, _NONE)
        leaf = torch.full_like(roots, _NONE)
        while True:
            idx = torch.nonzero(~placed & ~dead
                                & (ftotal < cfg["tries"])).squeeze(1)
            if idx.numel() == 0:
                break
            xi, ro, p = x[idx], roots[idx], pos[idx]
            r = rep_eff[idx] + ftotal[idx]
            itm, _ = self._descend(ro, xi, r, target, p)
            valid = (self._item_type(itm) == target) & (ro < 0)
            collide = (out[idx] == itm[:, None]).any(dim=1)
            if step_leaf:
                lf, lgot = self._leaf_attempts(
                    itm, xi, r, leafs[idx], wdev, p, cfg,
                    None if cfg["stable"] else p)
                reject = collide | ~lgot
            else:
                lf = itm
                reject = collide
                if target == 0:
                    reject = reject | self._dev_out(wdev, itm, xi)
            succ = valid & ~reject
            item[idx] = torch.where(succ, itm, item[idx])
            leaf[idx] = torch.where(succ, lf, leaf[idx])
            placed[idx] = succ
            dead[idx] = ~valid
            ftotal[idx] += (valid & reject).to(torch.int64)
        return item, leaf, placed

    def _firstn(self, x, wdev):
        """Any take → choose-chain → emit firstn rule (the reference
        crush_do_rule accumulation): each step appends at a per-lane
        outpos; its buffer is the next step's roots."""
        B = x.shape[0]
        dev = x.device
        ar = torch.arange(B, device=dev)
        result_max, nb = self.result_max, self._nb
        roots = torch.full((B, 1), self.take, dtype=torch.int64, device=dev)
        out = leafs = None
        for cfg in self.chain:
            reps = min(cfg["reps"], result_max)
            cap = min(roots.shape[1] * reps, result_max)
            out = torch.full((B, cap), _NONE, dtype=torch.int64, device=dev)
            leafs = out.clone()
            outpos = torch.zeros(B, dtype=torch.int64, device=dev)
            for s in range(roots.shape[1]):
                root = roots[:, s]
                entry = outpos.clone()
                # C do_rule: NONE slots from an under-filled earlier step
                # are negative but out of bucket range and do not descend
                root_ok = (root < 0) & ((-1 - root) < nb)
                for rep in range(reps):
                    if cfg["stable"]:
                        rep_eff = torch.full_like(outpos, rep)
                        rep_ok = torch.ones_like(root_ok)
                    else:
                        # C: rep starts at the entry outpos and stays
                        # below numrep
                        rep_eff = entry + rep
                        rep_ok = rep_eff < cfg["reps"]
                    active0 = rep_ok & root_ok & (outpos < result_max)
                    item, leaf, placed = self._rep_round(
                        x, root, out, leafs, wdev, active0, rep_eff,
                        outpos, cfg)
                    succ = placed & active0 & (item != _NONE)
                    slot = outpos.clamp(max=cap - 1)
                    out[ar, slot] = torch.where(succ, item, out[ar, slot])
                    leafs[ar, slot] = torch.where(succ, leaf,
                                                  leafs[ar, slot])
                    outpos = outpos + succ.to(torch.int64)
            roots = out
        last = self.chain[-1]
        return leafs if last["leaf"] and last["target"] != 0 else out

    # -- indep --------------------------------------------------------------

    def _indep_leaf(self, host, x, parent_r, rep, wdev, numrep, rtries):
        """Nested crush_choose_indep(left=1, outpos=rep, parent_r=r):
        inner draw index rep + parent_r + numrep·ftotal (the uniform
        adjustment per level of the inner descent)."""
        got = torch.zeros_like(host, dtype=torch.bool)
        dead = torch.zeros_like(got)
        leaf = torch.full_like(host, _NONE)
        base = parent_r + rep
        for ft in range(rtries):
            idx = torch.nonzero(~got & ~dead).squeeze(1)
            if idx.numel() == 0:
                break
            h, xi = host[idx], x[idx]
            cand, _ = self._descend(
                h, xi, base[idx], 0, torch.full_like(h, rep),
                indep_ft=torch.full_like(h, ft), numrep=numrep)
            valid = (cand >= 0) & (h < 0)
            succ = ~(self._dev_out(wdev, cand, xi) | ~valid)
            leaf[idx] = torch.where(succ, cand, leaf[idx])
            got[idx] = succ
            dead[idx] = ~valid
        return leaf, got

    def _indep(self, x, wdev):
        """Single-step indep rule (reference crush_choose_indep): rounds
        of ftotal over the positional slots still undefined; an invalid
        draw leaves a permanent NONE hole."""
        cfg = self.chain[0]
        B = x.shape[0]
        dev = x.device
        target = cfg["target"]
        numrep = cfg["reps"]                 # the r stride: not capped
        left = min(numrep, self.result_max)
        leafmode = cfg["leaf"] and target != 0
        out = torch.full((B, left), _UNDEF, dtype=torch.int64, device=dev)
        out2 = out.clone()
        for ftotal in range(cfg["tries"]):
            if not (out == _UNDEF).any():
                break
            for rep in range(left):
                idx = torch.nonzero(out[:, rep] == _UNDEF).squeeze(1)
                if idx.numel() == 0:
                    continue
                xi = x[idx]
                n = idx.numel()
                root = torch.full((n,), self.take, dtype=torch.int64,
                                  device=dev)
                # the top call's outpos (0) is the choose_args position
                itm, r_par = self._descend(
                    root, xi, torch.full_like(root, rep), target,
                    torch.zeros_like(root),
                    indep_ft=torch.full_like(root, ftotal), numrep=numrep)
                valid = self._item_type(itm) == target
                oi = out[idx]
                collide = (oi == itm[:, None]).any(dim=1)
                if leafmode:
                    lf, lgot = self._indep_leaf(itm, xi, r_par, rep, wdev,
                                                numrep, cfg["rtries"])
                    reject = collide | ~lgot
                else:
                    lf = itm
                    reject = collide
                    if target == 0:
                        reject = reject | self._dev_out(wdev, itm, xi)
                succ = valid & ~reject
                none = torch.full_like(itm, _NONE)
                out[idx, rep] = torch.where(
                    succ, itm, torch.where(valid, oi[:, rep], none))
                out2[idx, rep] = torch.where(
                    succ, lf, torch.where(valid, out2[idx, rep], none))
        res = out2 if leafmode else out
        return torch.where(res == _UNDEF, torch.full_like(res, _NONE), res)

    # -- multi-block rules --------------------------------------------------

    @staticmethod
    def _split_blocks(steps) -> list[list]:
        blocks: list[list] = []
        cur: list = []
        for s in steps:
            cur.append(s)
            if s.op == "emit":
                blocks.append(cur)
                cur = []
        if cur:
            blocks.append(cur)
        return blocks

    def _init_multiblock(self, blocks: list[list],
                         result_max: int | None) -> None:
        from .map import Rule as _Rule, Step as _Step
        for blk in blocks:
            ops = [s.op for s in blk]
            if not any(o.startswith("choose") for o in ops):
                raise NotImplementedError(
                    "multi-block rule with a chooseless block: use "
                    "the scalar oracle")
            if any(o.endswith("indep") for o in ops):
                raise NotImplementedError(
                    "indep in a multi-block rule: use the scalar "
                    "oracle")
        if result_max is None and any(
                s.arg1 <= 0 for blk in blocks for s in blk
                if s.op.startswith("choose")):
            raise ValueError(
                "numrep<=0 multi-block rule needs explicit result_max")
        # set_* steps persist across blocks in the reference VM
        carried: list = []
        sub_steps: list[list] = []
        for blk in blocks:
            sub_steps.append(list(carried) + list(blk))
            carried += [s for s in blk if s.op.startswith("set_")]
        subs = []
        for i, st in enumerate(sub_steps):
            st2 = []
            for s in st:
                if s.op.startswith("choose") and s.arg1 <= 0:
                    # reference: numrep += result_max at choose, capped
                    # at emit (the final trim)
                    s = _Step(op=s.op, arg1=s.arg1 + result_max,
                              arg2=s.arg2)
                    if s.arg1 <= 0:
                        raise ValueError(
                            "multi-block numrep resolves to <= 0")
                st2.append(s)
            subs.append(BatchMapper(
                self.cmap,
                _Rule(id=self.rule.id, name=f"{self.rule.name}#block{i}",
                      steps=st2, type=self.rule.type),
                result_max=None, chunk=self.chunk, device=self.device))
        self._subs = subs
        self.firstn = True
        prior = sum(sub.result_max for sub in subs)
        self.result_max = prior if result_max is None else result_max

    def _map_multi(self, xs: np.ndarray, reweight) -> torch.Tensor:
        cat = []
        for sub in self._subs:
            sub._straw2 = self._straw2
            cat.append(sub._map(xs, reweight))
        cat = torch.cat(cat, dim=1)
        # C's emit appends each block's w[0..wsize) to the result, and
        # no block reads an earlier one: a block that came up short
        # leaves no slot, so every block's NONE padding squeezes out
        # (in order) before the row is cut at result_max
        keep = cat != _NONE
        dest = torch.where(keep, keep.cumsum(1) - 1, cat.shape[1])
        out = torch.full((cat.shape[0], cat.shape[1] + 1), _NONE,
                         dtype=cat.dtype, device=cat.device)
        out.scatter_(1, dest, cat)
        return self._fit(out[:, :-1])

    def _fit(self, res: torch.Tensor) -> torch.Tensor:
        """``[n, w]`` rows NONE-padded or cut to ``result_max``."""
        R = self.result_max
        if res.shape[1] < R:
            res = torch.cat([res, torch.full(
                (res.shape[0], R - res.shape[1]), _NONE, dtype=res.dtype,
                device=res.device)], dim=1)
        return res[:, :R]

    def _chunk(self) -> int:
        """PGs a chunk maps: ``chunk``, or as many as ``CHUNK_BYTES`` of
        int64 intermediates hold.  A lane holds about a dozen ``[S]``
        rows where a level hashes a whole row in torch (the plain
        straw2, which CPU tensors take, and the legacy algorithms), else
        a few ``[result_max]`` rows and lane scalars."""
        if self.chunk:
            return self.chunk
        if (self.device.type == "cpu"
                or self._straw2 is not K7.straw2_choose
                or self._static["algs"] != ["straw2"]):
            lane = 8 * 12 * self._S
        else:
            lane = 8 * (8 * self.result_max + 96)
        return max(1, CHUNK_BYTES // lane)

    # -- the entry point ----------------------------------------------------

    def __call__(self, xs, reweight=None) -> np.ndarray:
        xs = np.asarray(xs, dtype=np.uint32)
        ln = DeviceProfiler.active().start(
            "crush_map", bytes_in=xs.nbytes + 4 * max(self.cmap.max_devices,
                                                      1),
            rows=len(xs), rows_used=len(xs), cache_hit=self.cache_hit)
        try:
            out = self._map(xs, reweight).cpu().numpy()
        except Exception:
            if ln is not None:
                ln.abort()
            raise
        if ln is not None:
            ln.finish(bytes_out=out.nbytes)
        return out

    def _map(self, xs, reweight) -> torch.Tensor:
        """``__call__``'s placements as an int32 tensor on the device."""
        xs = np.asarray(xs, dtype=np.uint32)
        if self._subs is not None:
            return self._map_multi(xs, reweight)
        W = max(self.cmap.max_devices, 1)
        if reweight is None:
            reweight = np.full(W, 0x10000, dtype=np.uint32)
        else:
            # is_out treats a device past the end of the vector as
            # weight 0 (out): a short vector zero-pads; entries past
            # max_devices can never be drawn, so a long one trims
            reweight = np.asarray(reweight, dtype=np.uint32)
            if len(reweight) < W:
                reweight = np.pad(reweight, (0, W - len(reweight)))
            elif len(reweight) > W:
                reweight = reweight[:W]
        wdev = torch.from_numpy(reweight.astype(np.int64)).to(self.device)
        fn = self._firstn if self.firstn else self._indep
        chunk = self._chunk()
        parts = [torch.zeros((0, self.result_max), dtype=torch.int32,
                             device=self.device)]
        for lo in range(0, len(xs), chunk):
            x = torch.from_numpy(
                xs[lo:lo + chunk].astype(np.int64)).to(self.device)
            parts.append(self._fit(fn(x, wdev)).to(torch.int32))
        return torch.cat(parts)
