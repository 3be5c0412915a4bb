"""Scalar CRUSH rule engine — the semantics oracle.

A faithful Python rendering of the reference's rule VM
(`crush_do_rule` / `crush_choose_firstn` / `crush_choose_indep` /
`bucket_straw2_choose` / `bucket_perm_choose` in `src/crush/mapper.c`,
SURVEY.md §3.3, §4.5), reconstructed from upstream semantics (the mount
was empty — SURVEY.md §0; re-verify).  This scalar form is the spec the
batched mapper (`torch_mapper.py`) is tested bit-exact against; it is
NOT the performance path.

Covered: straw2 and uniform buckets, firstn and indep selection with the
full retry/collision/reject structure, chooseleaf recursion (vary_r,
stable, descend_once), reweights (`is_out`), per-rule tunable override
steps, and balancer choose_args (weight-set + id substitution).
"""

from __future__ import annotations

import numpy as np

from .hash import crush_hash32_2, crush_hash32_3, crush_hash32_4
from .ln import crush_ln
from .map import CRUSH_ITEM_NONE, CRUSH_ITEM_UNDEF, Bucket, CrushMap, Rule

_S64_MIN = -(1 << 63)
_U64_MASK = (1 << 64) - 1


def _div64(a: int, w: int) -> int:
    """C `div64_s64`: truncation toward zero."""
    if a >= 0:
        return a // w
    return -((-a) // w)


def _straw2_draw(u: int, weight: int) -> int:
    """One straw2 'straw length' for hash draw u and 16.16 weight.

    draw = ln(u) / (w/2^16) = (ln << 16) / w, i.e. the minimum-of-
    exponentials trick: P(item i wins) = w_i / Σw.  The s64 left shift
    wraps mod 2^64 for |ln| > 2^47 (u ≤ 255), as C's would — emulated
    exactly so the batched path can match bit-for-bit.
    """
    if weight == 0:
        return _S64_MIN
    ln = int(crush_ln(u)) - (1 << 48)          # ∈ [-2^48, 0]
    shifted = (ln << 16) & _U64_MASK
    if shifted >= 1 << 63:
        shifted -= 1 << 64
    return _div64(shifted, weight)


def bucket_straw2_choose(cmap: CrushMap, bucket: Bucket, x: int, r: int,
                         position: int = 0) -> int:
    arg = cmap.choose_args.get(bucket.id)
    if arg and arg.get("weight_set"):
        ws = arg["weight_set"]
        weights = ws[min(position, len(ws) - 1)]
    else:
        weights = bucket.weights
    ids = arg["ids"] if arg and arg.get("ids") else bucket.items
    high, high_draw = 0, 0
    for i in range(bucket.size):
        u = int(crush_hash32_3(x, ids[i], r)) & 0xFFFF
        draw = _straw2_draw(u, weights[i])
        if i == 0 or draw > high_draw:
            high, high_draw = i, draw
    return bucket.items[high]


class CrushWork:
    """Per-mapping scratch state (uniform-bucket permutation cache).

    Reference: `struct crush_work_bucket` — perm state is keyed by bucket
    and reset when x changes.
    """

    def __init__(self):
        self.perm: dict[int, dict] = {}

    def bucket_state(self, bid: int) -> dict:
        return self.perm.setdefault(bid, {"perm_x": None, "perm_n": 0,
                                          "perm": []})


def bucket_perm_choose(bucket: Bucket, work: CrushWork, x: int, r: int) -> int:
    st = work.bucket_state(bucket.id)
    size = bucket.size
    pr = r % size
    if st["perm_x"] != x or st["perm_n"] == 0:
        st["perm_x"] = x
        if pr == 0:
            s = int(crush_hash32_3(x, bucket.id, 0)) % size
            st["perm"] = [s] + [0] * (size - 1)
            st["perm_n"] = 0xFFFF  # lazy: only slot 0 materialized
            return bucket.items[s]
        st["perm"] = list(range(size))
        st["perm_n"] = 0
    elif st["perm_n"] == 0xFFFF:
        # clean up after the r=0 fast path
        perm = st["perm"]
        for i in range(1, size):
            perm[i] = i
        perm[perm[0]] = 0
        st["perm_n"] = 1
    perm = st["perm"]
    while st["perm_n"] <= pr:
        p = st["perm_n"]
        if p < size - 1:
            i = int(crush_hash32_3(x, bucket.id, p)) % (size - p)
            if i:
                perm[p + i], perm[p] = perm[p], perm[p + i]
        st["perm_n"] += 1
    return bucket.items[perm[pr]]


def _bucket_cache(bucket: Bucket, kind: str, build):
    """Derived per-bucket tables (straw scalers, tree node weights,
    list prefix sums) — computed once per weight vector, like the
    reference's build-time ``crush_calc_straw``/``crush_make_tree_
    bucket``, and invalidated when the weights change."""
    key = (kind, tuple(bucket.weights), bucket.size)
    cache = getattr(bucket, "_legacy_cache", None)
    if cache is None or cache[0] != key:
        bucket._legacy_cache = (key, build())
    return bucket._legacy_cache[1]


def bucket_list_choose(bucket: Bucket, x: int, r: int) -> int:
    """RUSH_P list bucket: walk newest→oldest item; item i keeps the
    draw with probability weight_i / sum(weights_0..i) (reference
    ``bucket_list_choose``)."""
    def build():
        sums, acc = [], 0
        for w in bucket.weights:
            acc += w
            sums.append(acc)
        return sums

    sums = _bucket_cache(bucket, "list", build)
    for i in range(bucket.size - 1, -1, -1):
        if sums[i] == 0:
            continue
        w = int(crush_hash32_4(x, bucket.items[i], r, bucket.id)) & 0xFFFF
        w = (w * sums[i]) >> 16
        if w < bucket.weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def _tree_height(n: int) -> int:
    h = 0
    while (n & 1) == 0:
        h += 1
        n >>= 1
    return h


def _tree_node_weights(bucket: Bucket) -> tuple[list[int], int]:
    """Build the in-order-labelled weight tree (reference
    ``crush_make_tree_bucket``): item i sits at node 2i+1; internal
    node weight = sum of its subtree."""
    size = bucket.size
    depth = 1
    t = max(size - 1, 0)
    while t:
        t >>= 1
        depth += 1
    num_nodes = 1 << depth
    nodes = [0] * num_nodes

    def fill(n: int) -> int:
        if n & 1:                        # leaf
            i = n >> 1
            nodes[n] = bucket.weights[i] if i < size else 0
            return nodes[n]
        h = _tree_height(n)
        nodes[n] = fill(n - (1 << (h - 1))) + fill(n + (1 << (h - 1)))
        return nodes[n]

    fill(num_nodes >> 1)
    return nodes, num_nodes


def bucket_tree_choose(bucket: Bucket, work: CrushWork, x: int,  # noqa: ARG001
                       r: int) -> int:
    """Weighted binary descent (reference ``bucket_tree_choose``)."""
    if bucket.size == 0:
        # do_rule rejects empty buckets before choosing; direct calls
        # must not walk a weightless tree
        raise ValueError("empty tree bucket")
    nodes, num_nodes = _bucket_cache(
        bucket, "tree", lambda: _tree_node_weights(bucket))
    n = num_nodes >> 1
    while (n & 1) == 0:
        w = nodes[n]
        t = (int(crush_hash32_4(x, n, r, bucket.id)) * w) >> 32
        h = _tree_height(n)
        left = n - (1 << (h - 1))
        n = left if t < nodes[left] else n + (1 << (h - 1))
    # an all-zero-weight subtree can land the descent on a padding
    # leaf; clamp to a real item — it is then rejected by is_out
    # (its weight is necessarily zero for this to be reachable)
    return bucket.items[min(n >> 1, bucket.size - 1)]


def calc_straw_scalers(weights: list[int]) -> list[int]:
    """Legacy straw scalers (reference ``crush_calc_straw``,
    straw_calc_version 0 algorithm; the v1 scaler fix for repeated
    weights is not separately reproducible — reference source
    unavailable, SURVEY.md §0 — so both versions use this published
    construction).  Double-precision, matching the C build path."""
    size = len(weights)
    order = sorted(range(size), key=lambda i: (weights[i], i))
    straws = [0] * size
    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        if weights[order[i]] == 0:
            straws[order[i]] = 0
            i += 1
            continue
        straws[order[i]] = int(straw * 0x10000)
        i += 1
        if i == size:
            break
        if weights[order[i]] == weights[order[i - 1]]:
            continue
        wbelow += float(weights[order[i - 1]] - lastw) * numleft
        for j in range(i, size):
            if weights[order[j]] == weights[order[i]]:
                numleft -= 1
            else:
                break
        wnext = numleft * (weights[order[i]] - weights[order[i - 1]])
        pbelow = wbelow / (wbelow + wnext)
        straw *= (1.0 / pbelow) ** (1.0 / numleft)
        lastw = weights[order[i - 1]]
    return straws


def bucket_straw_choose(bucket: Bucket, work: CrushWork, x: int,  # noqa: ARG001
                        r: int) -> int:
    """Legacy straw: draw = 16-bit hash × precomputed scaler, max wins
    (reference ``bucket_straw_choose``)."""
    straws = _bucket_cache(
        bucket, "straw", lambda: calc_straw_scalers(bucket.weights))
    high, high_draw = 0, 0
    for i in range(bucket.size):
        draw = (int(crush_hash32_3(x, bucket.items[i], r)) & 0xFFFF) \
            * straws[i]
        if i == 0 or draw > high_draw:
            high, high_draw = i, draw
    return bucket.items[high]


def crush_bucket_choose(cmap: CrushMap, bucket: Bucket, work: CrushWork,
                        x: int, r: int, position: int = 0) -> int:
    if bucket.alg == "straw2":
        return bucket_straw2_choose(cmap, bucket, x, r, position)
    if bucket.alg == "uniform":
        return bucket_perm_choose(bucket, work, x, r)
    if bucket.alg == "list":
        return bucket_list_choose(bucket, x, r)
    if bucket.alg == "tree":
        return bucket_tree_choose(bucket, work, x, r)
    if bucket.alg == "straw":
        return bucket_straw_choose(bucket, work, x, r)
    raise NotImplementedError(f"bucket alg {bucket.alg!r}")


def is_out(cmap: CrushMap, weight: list[int], item: int, x: int) -> bool:
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (int(crush_hash32_2(x, item)) & 0xFFFF) >= w


def crush_choose_firstn(cmap: CrushMap, work: CrushWork, bucket: Bucket,
                        weight: list[int], x: int, numrep: int, type_: int,
                        out: list[int], outpos: int, out_size: int,
                        tries: int, recurse_tries: int,
                        local_retries: int, local_fallback_retries: int,
                        recurse_to_leaf: bool, vary_r: int, stable: int,
                        out2: list[int] | None, parent_r: int) -> int:
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        retry_descent = True
        item = 0
        while retry_descent:
            retry_descent = False
            in_bucket = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                collide = False
                r = rep + parent_r + ftotal
                if in_bucket.size == 0:
                    reject = True
                else:
                    if (local_fallback_retries > 0
                            and flocal >= (in_bucket.size >> 1)
                            and flocal > local_fallback_retries):
                        item = bucket_perm_choose(in_bucket, work, x, r)
                    else:
                        item = crush_bucket_choose(cmap, in_bucket, work, x, r,
                                                   outpos)
                    if item >= cmap.max_devices:
                        skip_rep = True
                        break
                    itemtype = cmap.item_type(item)
                    if itemtype != type_:
                        if item >= 0 or (-1 - item) >= len(cmap.buckets):
                            skip_rep = True
                            break
                        in_bucket = cmap.bucket(item)
                        retry_bucket = True
                        continue
                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            if crush_choose_firstn(
                                    cmap, work, cmap.bucket(item), weight, x,
                                    1 if stable else outpos + 1, 0,
                                    out2, outpos, count,
                                    recurse_tries, 0,
                                    local_retries, local_fallback_retries,
                                    False, vary_r, stable,
                                    None, sub_r) <= outpos:
                                reject = True  # didn't get a leaf
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = is_out(cmap, weight, item, x)
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0
                          and flocal <= in_bucket.size + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
                    # fall out of the loop body; the while re-checks
                    # retry_bucket (C: do { … } while (retry_bucket))
            if skip_rep:
                break
        if not skip_rep:
            out[outpos] = item
            outpos += 1
            count -= 1
        rep += 1
    return outpos


def crush_choose_indep(cmap: CrushMap, work: CrushWork, bucket: Bucket,
                       weight: list[int], x: int, left: int, numrep: int,
                       type_: int, out: list[int], outpos: int,
                       tries: int, recurse_tries: int, recurse_to_leaf: bool,
                       out2: list[int] | None, parent_r: int) -> None:
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[rep] = CRUSH_ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != CRUSH_ITEM_UNDEF:
                continue
            in_bucket = bucket
            while True:
                r = rep + parent_r
                if in_bucket.alg == "uniform" and in_bucket.size % numrep == 0:
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_bucket.size == 0:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                item = crush_bucket_choose(cmap, in_bucket, work, x, r, outpos)
                if item >= cmap.max_devices:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                itemtype = cmap.item_type(item)
                if itemtype != type_:
                    if item >= 0 or (-1 - item) >= len(cmap.buckets):
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_bucket = cmap.bucket(item)
                    continue
                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        crush_choose_indep(
                            cmap, work, cmap.bucket(item), weight, x,
                            1, numrep, 0, out2, rep,
                            recurse_tries, 0, False, None, r)
                        if out2[rep] == CRUSH_ITEM_NONE:
                            break
                    else:
                        out2[rep] = item
                if itemtype == 0 and is_out(cmap, weight, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == CRUSH_ITEM_UNDEF:
            out[rep] = CRUSH_ITEM_NONE
        if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
            out2[rep] = CRUSH_ITEM_NONE


def do_rule(cmap: CrushMap, rule: Rule | int, x: int, result_max: int,
            weight: list[int] | None = None) -> list[int]:
    """Map input x through a rule → ordered device list.

    firstn rules return a possibly-shorter list (failures compacted);
    indep rules return exactly result_max slots with CRUSH_ITEM_NONE holes.
    """
    if isinstance(rule, int):
        rule = cmap.rule_by_id(rule)
    if weight is None:
        weight = [0x10000] * cmap.max_devices
    t = cmap.tunables
    choose_tries = t.choose_total_tries
    choose_leaf_tries = 0
    choose_local_retries = t.choose_local_tries
    choose_local_fallback_retries = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable
    work = CrushWork()

    result: list[int] = []
    w: list[int] = []
    o = [0] * (result_max * 4 + 16)
    c = [0] * (result_max * 4 + 16)

    for step in rule.steps:
        op = step.op
        if op == "take":
            w = [step.arg1]
        elif op == "set_choose_tries":
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif op == "set_chooseleaf_tries":
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif op == "set_choose_local_tries":
            if step.arg1 >= 0:
                choose_local_retries = step.arg1
        elif op == "set_choose_local_fallback_tries":
            if step.arg1 >= 0:
                choose_local_fallback_retries = step.arg1
        elif op == "set_chooseleaf_vary_r":
            if step.arg1 >= 0:
                vary_r = step.arg1
        elif op == "set_chooseleaf_stable":
            if step.arg1 >= 0:
                stable = step.arg1
        elif op in ("choose_firstn", "chooseleaf_firstn",
                    "choose_indep", "chooseleaf_indep"):
            if not w:
                continue
            firstn = op.endswith("firstn")
            recurse_to_leaf = op.startswith("chooseleaf")
            osize = 0
            for wi in w:
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                if wi >= 0 or (-1 - wi) >= len(cmap.buckets):
                    continue  # probably CRUSH_ITEM_NONE
                bucket = cmap.bucket(wi)
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    osize = crush_choose_firstn(
                        cmap, work, bucket, weight, x, numrep, step.arg2,
                        o, osize, result_max - osize,
                        choose_tries, recurse_tries,
                        choose_local_retries, choose_local_fallback_retries,
                        recurse_to_leaf, vary_r, stable,
                        c, 0)
                else:
                    out_size = min(numrep, result_max - osize)
                    crush_choose_indep(
                        cmap, work, bucket, weight, x, out_size, numrep,
                        step.arg2, o, osize,
                        choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, c, 0)
                    osize += out_size
            if recurse_to_leaf:
                o[:osize] = c[:osize]
            w = o[:osize]
        elif op == "emit":
            for item in w:
                if len(result) < result_max:
                    result.append(item)
            w = []
        else:
            raise ValueError(f"unknown rule step op {op!r}")
    return result
