"""HTTP serving layer: the codec as a long-lived network service (counterpart
of `vqvdb_tpu/serving.py`, with its endpoints, bodies and counters).

One warm `VQCodec` (weights on the card, kernels built, latent shape
checked at start) sits behind a small threaded HTTP API:

    GET  /healthz            -> {"status": "ok", model/config info}
    GET  /stats              -> request counters, micro-batching counts and
                                the codec's stage-profiler report
    POST /encode?name=NAME   -> body: .npy bytes (dense volume [X,Y,Z(,C)]
                                or leaf array [N,8,8,8(,C)]);
                                response: .vqvdb bytes
    POST /decode             -> body: .vqvdb bytes;
                                response: .npz with {name}_leaves /
                                {name}_origins arrays per grid
    POST /encode_leaves      -> body: .npy leaves [N,8,8,8(,C)];
                                response: .npy indices [N,4,4,4(,S)]
    POST /decode_indices     -> body: .npy indices [N,4,4,4(,S)];
                                response: .npy leaves [N,8,8,8,C]

A lock serialises device work (the codec's pinned staging buffers and its
one stream); request parsing and response serialisation run in the
handler threads. The leaf endpoints are micro-batched: concurrent small
requests (a render farm's traffic: many clients, a few hundred leaves each)
are coalesced into shared device steps of up to the codec's batch size
instead of each paying a padded step (`MicroBatcher`). The codec returns
arrays the caller owns, so results leave the lock safely. A leaf request is
validated before it is queued, so one malformed request cannot fail the
step it would share. Errors are 400 (with the exception's message), 404 for
an unknown path and 413 for a body over `max_body_bytes`. Start with
`python -m vqvdb_tpu_torch.cli serve --model m.vqmodel --port 8990`.
"""

from __future__ import annotations

import io
import json
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.vdb.grid import LeafGrid


class MicroBatcher:
    """Coalesces concurrent requests into shared device steps.

    Callers submit arrays with a shared trailing shape and block for their
    slice of the result; one worker thread drains the queue, concatenates up
    to `batch_size` rows (waiting at most `max_wait_ms` after the first
    pending item for stragglers), runs one step and hands each caller its
    rows. A large submission passes through in its own step; the codec below
    splits and pads it. `close()` stops the worker once the queue is empty.
    """

    def __init__(self, step_fn, batch_size: int, max_wait_ms: float = 5.0) -> None:
        self._step = step_fn
        self.batch_size = int(batch_size)
        self.max_wait_s = max_wait_ms / 1e3
        self._cv = threading.Condition()
        self._pending: list = []  # [(arr, slot)]
        self._closed = False
        self.steps = 0
        self.coalesced = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="vqvdb-microbatcher")
        self._worker.start()

    def submit(self, arr: np.ndarray) -> np.ndarray:
        slot = {"event": threading.Event(), "out": None, "err": None}
        with self._cv:
            if self._closed:
                raise RuntimeError("the micro-batcher is closed")
            self._pending.append((arr, slot))
            self._cv.notify()
        slot["event"].wait()
        if slot["err"] is not None:
            raise slot["err"]
        return slot["out"]

    def close(self, timeout: float = 10.0) -> None:
        """Stop taking work; the worker finishes what is queued and exits."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout)

    def _take_batch(self) -> list:
        with self._cv:
            while not self._pending and not self._closed:
                self._cv.wait()
            deadline = time.time() + self.max_wait_s
            total = sum(a.shape[0] for a, _ in self._pending)
            while total < self.batch_size and not self._closed:
                remaining = deadline - time.time()
                if remaining <= 0 or not self._cv.wait(timeout=remaining):
                    break
                total = sum(a.shape[0] for a, _ in self._pending)
            batch, taken = [], 0
            while self._pending and taken < self.batch_size:
                arr, slot = self._pending.pop(0)
                batch.append((arr, slot))
                taken += arr.shape[0]
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:  # closed and drained
                return
            arrs = [a for a, _ in batch]
            try:
                out = self._step(np.concatenate(arrs, axis=0) if len(arrs) > 1 else arrs[0])
                self.steps += 1
                self.coalesced += len(batch) - 1
                off = 0
                for arr, slot in batch:
                    n = arr.shape[0]
                    slot["out"] = out[off:off + n]
                    off += n
                    slot["event"].set()
            except Exception as e:  # the step failed: every waiter gets the error
                for _, slot in batch:
                    slot["err"] = e
                    slot["event"].set()


class CodecService:
    """A warm codec with counters, a device lock and two micro-batchers."""

    def __init__(self, codec: VQCodec, *, max_body_bytes: int = 1 << 30) -> None:
        self.codec = codec
        self.lock = threading.Lock()           # serialises device work
        self.counters_lock = threading.Lock()  # guards counter read-modify-write
        self.counters = {"encode": 0, "decode": 0, "encode_leaves": 0,
                         "decode_indices": 0, "errors": 0}
        self.max_body_bytes = max_body_bytes
        self.started = time.time()
        codec.check_latent_shape()  # builds the kernels and checks the model up front

        def _enc_step(leaves: np.ndarray) -> np.ndarray:
            with self.lock:
                return codec.encode_leaves(leaves)

        def _dec_step(indices: np.ndarray) -> np.ndarray:
            with self.lock:
                return codec.decode_indices(indices)

        self.encode_batcher = MicroBatcher(_enc_step, codec.ccfg.batch_size)
        self.decode_batcher = MicroBatcher(_dec_step, codec.ccfg.batch_size)

    def close(self) -> None:
        """Stop both micro-batchers' workers."""
        self.encode_batcher.close()
        self.decode_batcher.close()

    def bump(self, key: str) -> None:
        with self.counters_lock:
            self.counters[key] += 1

    # -- operations -------------------------------------------------------
    def grid_of_npy(self, raw: bytes, name: str) -> LeafGrid:
        """The LeafGrid `/encode` compresses: a leaf array gets origins on a
        cube of side ceil(N^(1/3)) leaves; a dense volume is sparsified."""
        arr = np.load(io.BytesIO(raw), allow_pickle=False)
        if arr.ndim >= 4 and arr.shape[1:4] == (8, 8, 8):
            n = arr.shape[0]
            side = int(np.ceil(n ** (1 / 3)))
            origins = np.stack(np.unravel_index(np.arange(n), (side, side, side)),
                               axis=1).astype(np.int32) * 8
            return LeafGrid(name, origins, arr)
        return LeafGrid.from_dense(name, arr)

    def encode_npy(self, raw: bytes, name: str) -> bytes:
        grid = self.grid_of_npy(raw, name)
        with tempfile.NamedTemporaryFile(suffix=".vqvdb") as f:
            with self.lock:
                self.codec.compress(grid, f.name)
            self.bump("encode")
            return Path(f.name).read_bytes()

    def decode_vqvdb(self, raw: bytes) -> bytes:
        with tempfile.NamedTemporaryFile(suffix=".vqvdb") as f:
            Path(f.name).write_bytes(raw)
            with self.lock:
                grids, _ = self.codec.decompress(f.name)
        out = io.BytesIO()
        arrays = {}
        for g in grids:
            arrays[f"{g.name}_leaves"] = g.leaves
            arrays[f"{g.name}_origins"] = g.origins
        np.savez(out, **arrays)
        self.bump("decode")
        return out.getvalue()

    def encode_leaves_npy(self, raw: bytes) -> bytes:
        leaves = np.load(io.BytesIO(raw), allow_pickle=False)
        if leaves.ndim == 4:
            leaves = leaves[..., None]
        want_c = self.codec.mcfg.in_channels
        if leaves.ndim != 5 or leaves.shape[1:4] != (8, 8, 8) or leaves.shape[4] != want_c:
            raise ValueError(f"expected leaves [N,8,8,8,{want_c}], got {leaves.shape}")
        idx = self.encode_batcher.submit(np.ascontiguousarray(leaves, np.float32))
        self.bump("encode_leaves")
        out = io.BytesIO()
        np.save(out, idx)
        return out.getvalue()

    def decode_indices_npy(self, raw: bytes) -> bytes:
        idx = np.load(io.BytesIO(raw), allow_pickle=False)
        ishape = self.codec.mcfg.index_shape
        if idx.shape[1:] != ishape:
            raise ValueError(f"expected indices [N,{ishape}], got {idx.shape}")
        leaves = self.decode_batcher.submit(np.ascontiguousarray(idx))
        self.bump("decode_indices")
        out = io.BytesIO()
        np.save(out, leaves)
        return out.getvalue()

    def info(self) -> dict:
        return {
            "status": "ok",
            "model": {
                "variant": self.codec.mcfg.variant,
                "num_embeddings": self.codec.mcfg.num_embeddings,
                "embedding_dim": self.codec.mcfg.embedding_dim,
            },
            "batch_size": self.codec.ccfg.batch_size,
            "compute_dtype": self.codec.ccfg.compute_dtype,
        }

    def stats(self) -> dict:
        with self.counters_lock:
            counters = dict(self.counters)
        return {
            "uptime_s": time.time() - self.started,
            "counters": counters,
            "microbatch": {
                "encode": {"steps": self.encode_batcher.steps,
                           "coalesced": self.encode_batcher.coalesced},
                "decode": {"steps": self.decode_batcher.steps,
                           "coalesced": self.decode_batcher.coalesced},
            },
            "profile": self.codec.profiler.report(),
        }


class _Server(ThreadingHTTPServer):
    # A farm opens many connections at once: socketserver's default listen
    # backlog of 5 let the kernel reset the rest (32 clients on one card).
    request_queue_size = 128


def make_server(service: CodecService, host: str = "127.0.0.1",
                port: int = 8990) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode())

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, service.info())
            elif path == "/stats":
                self._json(200, service.stats())
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            parsed = urlparse(self.path)
            length = int(self.headers.get("Content-Length", 0))
            if length > service.max_body_bytes:
                service.bump("errors")
                self._json(413, {"error": f"body of {length} B exceeds limit "
                                          f"of {service.max_body_bytes} B"})
                return
            raw = self.rfile.read(length)
            try:
                if parsed.path == "/encode":
                    name = parse_qs(parsed.query).get("name", ["density"])[0]
                    self._send(200, service.encode_npy(raw, name), "application/octet-stream")
                elif parsed.path == "/decode":
                    self._send(200, service.decode_vqvdb(raw), "application/octet-stream")
                elif parsed.path == "/encode_leaves":
                    self._send(200, service.encode_leaves_npy(raw), "application/octet-stream")
                elif parsed.path == "/decode_indices":
                    self._send(200, service.decode_indices_npy(raw),
                               "application/octet-stream")
                else:
                    self._json(404, {"error": f"unknown path {parsed.path}"})
            except Exception as e:  # the request failed: a 400 with its message
                service.bump("errors")
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return _Server((host, port), Handler)


def serve(codec: VQCodec, host: str = "127.0.0.1", port: int = 8990) -> None:
    service = CodecService(codec)
    server = make_server(service, host, port)
    print(f"[serve] listening on http://{host}:{server.server_address[1]} "
          f"(model: {service.info()['model']})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()
