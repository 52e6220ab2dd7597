"""Egg processor: executes DTable compute jobs inside the storage node
(port of flashe_tpu/data/egg.py).

The reference's eggroll ships compute to "egg" processors colocated
with the storage service, so `map/mapValues/reduce/...` run near the
data instead of streaming every record to the submitting client
(arch/api/table/table.py:25-179 backed by remote execution in cluster
mode; the federation runtime likewise pulls table fragments server-side,
arch/api/transfer/cluster.py:154-303).  This module is that processor:

- The storage node (csrc/kvserver.cpp op 8, or the pure-python server
  in data/remote_kv.py) spawns `python -m flashe_tpu_torch.data.egg <addr>`
  per EXEC request, writes the job spec on stdin and relays the pickled
  result from stdout.
- The egg reads its source partitions from the *local* node over
  loopback (exactly how eggroll processors talk to their local storage
  service), applies the shipped function, and for map-like jobs routes
  each output record straight to the node that owns its output
  partition (the shuffle) — local or remote — never via the client.

Job spec (cloudpickle-serialized dict):
  src_ns/src_name/src_nparts  source table identity
  parts                       partition indices this egg is responsible
                              for (the node's slice of the table)
  kind                        "map_partitions" | "reduce" | "binary"
  fn                          map: fn(part_idx, items_iter) -> iterable
                              of (k, v) output records;
                              reduce: fn(acc, value) -> acc;
                              binary: combiner fn(v_self, v_other) (may
                              be None for subtract)
  out_ns/out_name/out_nparts  map/binary: output table identity
  out_nodes                   map/binary: ordered node address list;
                              output partition p lives on node
                              out_nodes[p % len(out_nodes)]
  src2_ns/src2_name/src2_nparts  binary only: the co-partitioned right
                              table (same nparts + node list as src, so
                              partition p of both is local to this node)
  op                          binary only: "join" | "union" | "subtract"

Result dict: {"ok": bool, "pid": int, "value": partial-or-count,
              "records_in": int, "error": str (when not ok)}.
"""

from __future__ import annotations

import os
import struct
import sys
import traceback

from flashe_tpu_torch.data import codec

__all__ = ["run_job", "main"]


def _iter_decoded(src, part):
    for kb, vb in src.items(part):
        yield codec.dec(kb), codec.dec(vb)


def run_job(local_addr: str, spec: dict) -> dict:
    from flashe_tpu_torch.data.remote_kv import RemoteKVStore

    src = RemoteKVStore(local_addr, spec["src_ns"], spec["src_name"],
                        spec["src_nparts"])
    fn = spec["fn"]
    kind = spec["kind"]
    records_in = 0
    try:
        if kind == "reduce":
            acc = None
            seeded = False
            for part in spec["parts"]:
                for _, v in _iter_decoded(src, part):
                    records_in += 1
                    if not seeded:
                        acc, seeded = v, True
                    else:
                        acc = fn(acc, v)
            return {"ok": True, "pid": os.getpid(),
                    "value": acc, "seeded": seeded,
                    "records_in": records_in}
        if kind in ("map_partitions", "binary"):
            out_nodes = spec["out_nodes"]
            out_nparts = spec["out_nparts"]
            conns = {}
            pipes = {}

            def pipe_for(addr):
                """Pipelined writer per destination node: shuffle output
                streams without a per-record round-trip (statuses drain
                in batches — remote_kv._PutPipeline)."""
                p = pipes.get(addr)
                if p is None:
                    c = RemoteKVStore(addr, spec["out_ns"],
                                      spec["out_name"], out_nparts)
                    conns[addr] = c
                    p = pipes[addr] = c.pipeline()
                return p

            src2 = None
            if kind == "binary":
                src2 = RemoteKVStore(local_addr, spec["src2_ns"],
                                     spec["src2_name"],
                                     spec["src2_nparts"])
                op = spec["op"]

            written = 0
            for part in spec["parts"]:

                def counting(part=part):
                    nonlocal records_in
                    for kv in _iter_decoded(src, part):
                        records_in += 1
                        yield kv

                if kind == "map_partitions":
                    gen = fn(part, counting())
                else:
                    # co-partitioned binary op: partition `part` of both
                    # tables lives on this node (guarded client-side)
                    d2 = dict(_iter_decoded(src2, part))

                    def gen_binary(items, d2=d2):
                        seen = set()
                        for k, v in items:
                            if op == "join":
                                if k in d2:
                                    yield k, fn(v, d2[k])
                            elif op == "union":
                                seen.add(k)
                                yield (k, fn(v, d2[k]) if k in d2
                                       else v)
                            else:  # subtract
                                if k not in d2:
                                    yield k, v
                        if op == "union":
                            for k2, v2 in d2.items():
                                if k2 not in seen:
                                    yield k2, v2

                    gen = gen_binary(counting())

                for nk, nv in gen:
                    kb = codec.enc(nk)
                    p = codec.part_of(kb, out_nparts)
                    pipe_for(out_nodes[p % len(out_nodes)]).put(
                        p, kb, codec.enc(nv))
                    written += 1
            for pl in pipes.values():
                pl.drain()
            for c in conns.values():
                c.close()
            if src2 is not None:
                src2.close()
            return {"ok": True, "pid": os.getpid(), "value": written,
                    "records_in": records_in}
        return {"ok": False, "pid": os.getpid(),
                "error": f"unknown job kind {kind!r}"}
    except Exception:
        return {"ok": False, "pid": os.getpid(),
                "error": traceback.format_exc()}
    finally:
        src.close()


def _read_full(stream, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = stream.read(n - len(buf))
        if not part:
            raise EOFError("egg stdin closed early")
        buf += part
    return buf


def main(argv=None) -> int:
    """Single-shot: one length-prefixed spec on stdin -> one
    length-prefixed result on stdout.  `--loop`: stay resident and
    serve jobs until stdin closes — the persistent-processor mode the
    node's egg pool uses (eggroll keeps processor pools alive the same
    way; a fresh interpreter per job costs ~0.5 s of imports)."""
    argv = sys.argv[1:] if argv is None else argv
    loop = "--loop" in argv
    argv = [a for a in argv if a != "--loop"]
    if len(argv) != 1:
        print("usage: python -m flashe_tpu_torch.data.egg [--loop] "
              "<local_storage_addr>", file=sys.stderr)
        return 2
    import pickle

    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    while True:
        try:
            (n,) = struct.unpack("<Q", _read_full(stdin, 8))
        except EOFError:
            return 0  # pool shutdown: node closed our stdin
        body = _read_full(stdin, n)
        try:
            # unpickle INSIDE the guard: an import missing under the
            # egg's PYTHONPATH (or a cloudpickle mismatch) must come
            # back as an error result, not kill a pool worker whose
            # stderr is discarded
            spec = pickle.loads(body)
            result = run_job(argv[0], spec)
        except Exception:  # spec-level failure (bad connect, bad spec)
            result = {"ok": False, "pid": os.getpid(),
                      "error": traceback.format_exc()}
        payload = pickle.dumps(result, protocol=4)
        stdout.write(struct.pack("<Q", len(payload)) + payload)
        stdout.flush()
        if not loop:
            return 0


if __name__ == "__main__":
    sys.exit(main())
