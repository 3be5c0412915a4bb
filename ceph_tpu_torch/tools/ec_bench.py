"""Erasure-code benchmark — ``ceph_erasure_code_benchmark`` CLI parity,
port of ``ceph_tpu.tools.ec_bench`` onto the CUDA engine.

Same flags and JSON line as ceph_tpu's, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain versions).  The stripe batch is made
with numpy from seed 0, moved to the device once, and every timed
iteration ends in ``torch.cuda.synchronize()``.

- Plugins with an engine (jerasure, isa, shec, the bitmatrix codes)
  encode the whole batch in one device call; plugins without one
  (lrc, clay) encode stripe by stripe through ``code.encode``.
- Decode of an MDS code with an engine takes the first k survivors of
  each erasure pattern (jerasure's rule) in one device call; a non-MDS
  code (shec, lrc) or one without an engine asks the plugin what to
  read (``minimum_to_decode``) and decodes stripe by stripe.
- ``--verify`` checks parity against the numpy oracle before timing:
  ``rs.encode_oracle`` for a GF(2^8) matrix, the bitmatrix row walk
  for the bitmatrix codes, each layer's ``rs.encode_oracle`` in turn
  for lrc; clay, which has no matrix, is checked by decoding its first
  m data chunks back from the rest.  For decode it also checks the
  recovered data.

Example::

    python -m ceph_tpu_torch.tools.ec_bench --plugin torch_cuda \
        --workload encode --size 1048576 --batch 64 --iterations 20 \
        --parameter k=8 --parameter m=3 --verify --json
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import numpy as np
import torch

from ..ec import create_erasure_code
from ..ec.bitmatrix import BitMatrixECEngine
from ..ec.bitmatrix import encode_oracle as bitmatrix_oracle
from ..ec.interface import ECProfile
from ..ops import rs
from ..utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ec_bench", description=__doc__)
    p.add_argument("--plugin", "-P", default="torch_cuda")
    p.add_argument("--workload", "-w", choices=["encode", "decode"],
                   default="encode")
    p.add_argument("--iterations", "-i", type=int, default=1)
    p.add_argument("--size", "-s", type=int, default=1 << 20,
                   help="total payload bytes per stripe")
    p.add_argument("--parameter", "-p", action="append", default=[],
                   help="profile parameter k=v (repeatable)")
    p.add_argument("--erasures", "-e", type=int, default=1,
                   help="erasures per decode")
    p.add_argument("--erasures-generation", "-E",
                   choices=["random", "exhaustive"], default="random")
    p.add_argument("--erased", type=int, action="append", default=None,
                   help="explicit chunk id to erase (repeatable)")
    p.add_argument("--batch", "-b", type=int, default=None,
                   help="stripes per launch (default 1)")
    p.add_argument("--verify", "-v", action="store_true",
                   help="verify bytes against the numpy oracle")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain versions)")
    p.add_argument("--json", action="store_true", help="emit one JSON line")
    return p


def _fence(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def expected_parity(code, data: np.ndarray) -> np.ndarray | None:
    """The numpy oracle's parity for one ``[k, chunk]`` stripe, or
    None for a plugin with no matrix to check against (clay)."""
    if isinstance(getattr(code, "engine", None), BitMatrixECEngine):
        return bitmatrix_oracle(code.coding_matrix, data, code.w)
    if getattr(code, "coding_matrix", None) is not None:
        return rs.encode_oracle(code.coding_matrix, data)
    if hasattr(code, "layers"):             # lrc: layer by layer
        have = dict(zip(code.data_pos, data))
        for layer in code.layers:
            par = rs.encode_oracle(layer.coding_matrix, np.stack(
                [have[p] for p in layer.data_pos]))
            have.update(zip(layer.coding_pos, par))
        return np.stack([have[code._id_to_pos[i]]
                         for i in range(code.k, code.k + code.m)])
    return None


def run(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    for kv in args.parameter:
        if "=" not in kv:
            print(f"ec_bench: bad --parameter {kv!r} (expected key=value)",
                  file=sys.stderr)
            raise SystemExit(2)
    params = dict(kv.split("=", 1) for kv in args.parameter)
    params.setdefault("plugin", args.plugin)
    profile = ECProfile.parse(params)
    code = create_erasure_code(profile, device=args.device)
    engine = getattr(code, "engine", None)
    dev = engine.device if engine is not None else resolve_device(
        args.device)
    k, m = code.k, code.m

    rng = np.random.default_rng(0)
    chunk = code.get_chunk_size(args.size)
    batch = args.batch or 1
    data = rng.integers(0, 256, size=(batch, k, chunk), dtype=np.uint8)
    data_t = torch.from_numpy(data).to(dev) if engine is not None else None

    def encode_once():
        if engine is not None:
            return engine.encode_device(data_t)
        stripes = []
        for b in range(batch):
            out = code.encode(set(range(k, k + m)), data[b].reshape(-1))
            stripes.append(np.stack([out[i] for i in range(k, k + m)]))
        return np.stack(stripes)

    if args.erased:
        patterns = [tuple(sorted(args.erased))]
    elif args.erasures_generation == "exhaustive":
        patterns = list(itertools.combinations(range(k + m), args.erasures))
    else:
        patterns = [tuple(sorted(int(x) for x in rng.choice(
            k + m, size=args.erasures, replace=False)))
            for _ in range(args.iterations)]

    parity = None
    if args.workload == "decode" or args.verify:
        parity = encode_once()
        _fence(dev)
    nverify = min(batch, 4)
    if args.verify:
        got = (parity[:nverify].cpu().numpy()
               if isinstance(parity, torch.Tensor) else parity)
        for b in range(nverify):
            expect = expected_parity(code, data[b])
            if expect is None:
                # no matrix: the first m data chunks must decode back
                # from the other data chunks and the parity
                lost = set(range(min(m, k)))
                avail = {i: data[b, i] for i in range(k) if i not in lost}
                avail.update({k + j: got[b, j] for j in range(m)})
                back = code.decode(lost, avail)
                ok = all(np.array_equal(back[i], data[b, i]) for i in lost)
            else:
                ok = np.array_equal(got[b], expect)
            if not ok:
                raise AssertionError(
                    f"parity mismatch vs oracle at stripe {b}")

    total_bytes = 0
    if args.workload == "encode":
        encode_once()                        # warm: tables uploaded
        _fence(dev)
        t0 = time.perf_counter()
        for _ in range(args.iterations):
            encode_once()
            _fence(dev)
            total_bytes += batch * k * chunk
        elapsed = time.perf_counter() - t0
    elif engine is not None and code.is_mds:
        all_chunks = torch.cat([data_t, parity], dim=1)
        survivors = {p: torch.tensor(
            [i for i in range(k + m) if i not in p][:k], device=dev)
            for p in set(patterns)}
        stacks = {p: all_chunks.index_select(1, s).contiguous()
                  for p, s in survivors.items()}
        for p in stacks:
            out = engine.decode_device(stacks[p], p)   # warm each pattern
            if args.verify and not torch.equal(out[:nverify],
                                               data_t[:nverify]):
                raise AssertionError(f"decode mismatch for erasures {p}")
        _fence(dev)
        t0 = time.perf_counter()
        for it in range(args.iterations):
            p = patterns[it % len(patterns)]
            engine.decode_device(stacks[p], p)
            _fence(dev)
            total_bytes += batch * k * chunk
        elapsed = time.perf_counter() - t0
    else:
        # non-MDS or engine-less codes: ask the plugin what to read
        host_parity = (parity.cpu().numpy()
                       if isinstance(parity, torch.Tensor) else parity)
        all_chunks = np.concatenate([data, host_parity], axis=1)
        want = set(range(k))

        def decode_once(pattern):
            avail = set(range(k + m)) - set(pattern)
            reads = code.minimum_to_decode(want, avail)
            return [code.decode(want, {i: all_chunks[b, i] for i in reads})
                    for b in range(batch)]

        for p in set(patterns):
            outs = decode_once(p)                     # warm each pattern
            if args.verify and not all(
                    np.array_equal(outs[b][i], data[b, i])
                    for b in range(nverify) for i in want):
                raise AssertionError(f"decode mismatch for erasures {p}")
        _fence(dev)
        t0 = time.perf_counter()
        for it in range(args.iterations):
            decode_once(patterns[it % len(patterns)])
            _fence(dev)
            total_bytes += batch * k * chunk
        elapsed = time.perf_counter() - t0

    result = {
        "plugin": profile.plugin, "technique": profile.technique,
        "k": k, "m": m, "workload": args.workload,
        "size": args.size, "chunk": chunk, "batch": batch,
        "iterations": args.iterations,
        "seconds": elapsed,
        "GBps": total_bytes / elapsed / 1e9 if elapsed > 0 else float("inf"),
        "verified": bool(args.verify),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    if args.json:
        print(json.dumps(result))
    else:
        print(f"{elapsed:.6f}")  # reference prints elapsed seconds
        print(f"# {result['GBps']:.3f} GB/s "
              f"({profile.plugin}/{profile.technique} k={k} m={m} "
              f"chunk={chunk} batch={batch} x{args.iterations} on "
              f"{result['device']})", file=sys.stderr)
    return result


if __name__ == "__main__":
    run()
