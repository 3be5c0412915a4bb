"""Locally-repairable code plugin — port of ``ceph_tpu.ec.lrc``
(reference: ``src/erasure-code/lrc/ErasureCodeLrc.{h,cc}``).

The primitive is the reference's mapping+layers model:

- ``mapping`` — one symbol per chunk position: ``D`` data, ``_`` other.
- ``layers``  — list of patterns, one per sub-code; in each pattern, ``D``
  marks the layer's data positions, ``c`` its coding positions, ``_``
  positions it ignores.  Each layer is an independent RS (jerasure
  reed_sol_van) code over its positions.

``k=K m=M l=L`` profiles are expanded to mapping+layers the way the
reference documents (erasure-code-lrc.rst): (k+m) must divide into groups
of ``l``; each group is prefixed with one local parity; the m global
parities occupy the leading positions of each group.  Example k=4 m=2 l=3:

    mapping  "__DD__DD"
    layers   ["_cDD_cDD", "cDDD____", "____cDDD"]

The whole point of LRC is `minimum_to_decode`: a single lost chunk is
repaired from its *local* group (l reads) instead of k reads.

Every layer encodes and decodes on its own `MatrixECEngine` (the
``gf_words`` kernel on the card).
"""

from __future__ import annotations

import json

import numpy as np

from ..ops import rs
from .interface import ECError, ECProfile, ErasureCodeInterface
from .torch_backend import MatrixECEngine


class _Layer:
    def __init__(self, pattern: str, device=None):
        self.pattern = pattern
        self.data_pos = [i for i, s in enumerate(pattern) if s == "D"]
        self.coding_pos = [i for i, s in enumerate(pattern) if s == "c"]
        self.positions = sorted(self.data_pos + self.coding_pos)
        self.k = len(self.data_pos)
        self.m = len(self.coding_pos)
        if self.m == 0 or self.k == 0:
            raise ECError(f"layer {pattern!r} needs both D and c symbols")
        self.coding_matrix = rs.reed_sol_van_matrix(self.k, self.m)
        self.engine = MatrixECEngine(self.coding_matrix, self.k, self.m,
                                     device=device)

    def chunk_ids_in_layer_order(self) -> list[int]:
        """Global position ids in the layer's (data..., coding...) order."""
        return self.data_pos + self.coding_pos

    def try_decode(self, have: dict[int, np.ndarray]) -> dict[int, np.ndarray]:
        """If enough of this layer's chunks are present, recover the rest.
        Returns newly recovered {position: chunk}; empty if underdetermined."""
        ids = self.chunk_ids_in_layer_order()
        present = {local: have[pos] for local, pos in enumerate(ids)
                   if pos in have}
        missing = [local for local, pos in enumerate(ids) if pos not in have]
        if not missing or len(present) < self.k:
            return {}
        chunk_size = next(iter(present.values())).size
        full = self.engine.decode(present, chunk_size)
        return {ids[local]: full[local] for local in missing}


def _expand_kml(k: int, m: int, l: int) -> tuple[str, list[str]]:
    if (k + m) % l != 0:
        raise ECError(f"LRC k+m={k + m} must be a multiple of l={l}")
    groups = (k + m) // l
    if m % groups != 0:
        raise ECError(f"LRC m={m} must distribute evenly over {groups} groups")
    gm = m // groups  # globals per group
    mapping = ""
    global_layer = ""
    local_layers = []
    width = groups * (l + 1)
    for g in range(groups):
        mapping += "_" + "_" * gm + "D" * (l - gm)
        global_layer += "_" + "c" * gm + "D" * (l - gm)
    for g in range(groups):
        start = g * (l + 1)
        pat = ["_"] * width
        pat[start] = "c"
        for i in range(1, l + 1):
            pat[start + i] = "D"
        local_layers.append("".join(pat))
    return mapping, [global_layer] + local_layers


class ErasureCodeLrc(ErasureCodeInterface):
    is_mds = False  # locality layers: decodability depends on the layer map

    def __init__(self, profile: ECProfile, device=None):
        self.profile = profile
        extra = profile.extra
        if "mapping" in extra and "layers" in extra:
            mapping = extra["mapping"]
            layers_spec = extra["layers"]
            if isinstance(layers_spec, str):
                layers_spec = json.loads(layers_spec)
                layers_spec = [row[0] if isinstance(row, list) else row
                               for row in layers_spec]
        else:
            l = int(extra.get("l", 3))
            mapping, layers_spec = _expand_kml(profile.k, profile.m, l)
        self.mapping = mapping
        self.layers = [_Layer(p, device) for p in layers_spec]
        self.chunk_total = len(mapping)
        for layer in self.layers:
            if len(layer.pattern) != self.chunk_total:
                raise ECError("layer/mapping width mismatch")
        self.data_pos = [i for i, s in enumerate(mapping) if s == "D"]
        # interface ids: 0..k-1 are the data positions in order, k.. are the
        # remaining positions in order (matches the reference's remapping)
        self.k = len(self.data_pos)
        self.m = self.chunk_total - self.k
        other = [i for i in range(self.chunk_total) if mapping[i] != "D"]
        self._id_to_pos = self.data_pos + other
        self._pos_to_id = {p: i for i, p in enumerate(self._id_to_pos)}

    def get_alignment(self) -> int:
        return self.k * 8 * 4

    # -- core --------------------------------------------------------------
    def _encode_chunks(self, data: np.ndarray) -> np.ndarray:
        chunk = data.shape[1]
        have: dict[int, np.ndarray] = {
            pos: data[i] for i, pos in enumerate(self.data_pos)}
        for layer in self.layers:
            stacked = np.stack([have[p] for p in layer.data_pos])
            parity = layer.engine.encode(stacked)
            for j, pos in enumerate(layer.coding_pos):
                have[pos] = parity[j]
        out = np.zeros((self.m, chunk), dtype=np.uint8)
        for i in range(self.k, self.k + self.m):
            out[i - self.k] = have[self._id_to_pos[i]]
        return out

    def _decode_chunks(self, chunks, chunk_size, want=None):
        have = {self._id_to_pos[i]: c for i, c in chunks.items()}
        want_pos = ({self._id_to_pos[i] for i in want} if want is not None
                    else set(range(self.chunk_total)))
        progress = True
        while progress and not want_pos <= set(have):
            progress = False
            for layer in self.layers:
                recovered = layer.try_decode(have)
                if recovered:
                    have.update(recovered)
                    progress = True
        if not want_pos <= set(have):
            raise ECError("LRC: cannot recover wanted chunks from available set")
        return {i: have[self._id_to_pos[i]] for i in range(self.chunk_total)
                if self._id_to_pos[i] in have}

    # -- locality-aware minimum_to_decode ---------------------------------
    def minimum_to_decode(self, want_to_read, available):
        if want_to_read <= available:
            return set(want_to_read)
        want_pos = {self._id_to_pos[i] for i in want_to_read}
        avail_pos = {self._id_to_pos[i] for i in available}
        missing = want_pos - avail_pos
        needed: set[int] = set()
        for pos in missing:
            best = None
            for layer in self.layers:
                if pos not in layer.positions:
                    continue
                layer_missing = [p for p in layer.positions
                                 if p not in avail_pos]
                if len(layer.positions) - len(layer_missing) < layer.k:
                    continue  # layer itself underdetermined
                if len(layer_missing) > layer.m:
                    continue
                reads = set(layer.positions) & avail_pos
                if best is None or len(reads) < len(best):
                    best = reads
            if best is None:
                # fall back: full decode from any k+ available
                if len(available) < self.k:
                    raise ECError("LRC: not enough chunks to decode")
                return set(sorted(available))
            needed |= best
        needed_ids = {self._pos_to_id[p] for p in needed}
        return needed_ids | (want_to_read & available)
