"""Streaming codec: leaf batches <-> device <-> `.vqvdb` files, v3 to v6
(counterpart of `vqvdb_tpu/runtime/codec.py`).

Every device step runs at exactly `CodecConfig.batch_size` leaves (the
ragged tail is zero-padded and cropped on the host). On the card the loop
keeps `PIPELINE_DEPTH` steps in flight: each batch is staged in a pinned
host buffer, copied up, run, and copied back into another pinned buffer
without a wait; the host takes a batch's result only after the next batch
has been enqueued, so host I/O overlaps device work. On the CPU the same
loop runs synchronously.

Encode:  leaves -> encoder features -> score-argmin kernel (the 1x1
         projection folded in) -> indices [B,4,4,4]. The reference
         encoder runs its strided conv folded onto the packed grid
         (`pack_down_conv`) and, for scalar input, its 16-channel residual
         block as the fused kernel (`fuse_rb16`).
         With `fuse_proj_quantize=False`: projection -> nearest-code kernel.
         Residual-VQ models (S stages): projection -> per stage the
         nearest-code and dequantize kernels -> indices [B,4,4,4,S].
Decode:  indices -> dequantize kernel (once per stage, rows summed) ->
         decoder pre-tail -> folded tail GEMM + sigmoid / tanh. With
         `fuse_decoder_tail=False`: up_conv -> the final conv folded before
         the shuffle (`fuse_final_conv`, ops/subpixel.py), or the three
         tail ops with both off.

Indices are u8 for K <= 256; for larger codebooks u16 on the host (int16
bits in the pinned buffers) and int32 on the card. Files: v3 by default,
v4 when K > 256, v5 (compressed frames) and v6 (with the near-lossless
residual, whose encode batches also run the decode step, so the stored
correction is measured against the decode that `decompress` repeats).
`decode_stream` / `decompress` select grids by name and leaves by bounding
box; `compress_stream` encodes lazily read leaf streams.

`VQCodec.profiler` (`utils/profiler.py`) times each stage on the host clock
and counts it: the constructor's `init/weights`, `init/tail_fold`,
`init/score_operand`, `init/down_fold` and `init/replicate`; per batch
`host/stage_in` (the copy into the pinned input), `host/pad` (the ragged
tail zeroed), `device/dispatch` (the upload, the device steps and the
readback enqueued), `device/readback_wait` (the host waiting for a batch's
results, `_collect`) and, in `decompress`, `host/scatter` (the output grid allocated and
a batch's rows and origins copied into it). Under a running
`torch.profiler` each stage is also a trace range, and spans name the rest:
`host/file` (a file opened or closed), `host/read_frames`,
`host/write_frames`, `device/read_back` and the parts of each device step
(`decode/*`, `encode/*`, `rb/*`).

With a mesh (`parallel/mesh.py`) every padded batch is cut into the mesh's
shards; each local device runs the same steps (the same kernel launches) on
its shard, with its own copy of the weights and fold constants, its own
pinned buffer pair and its own stream, and with several devices the
shards' rows go back into the batch through `native_io.copy_into`. Shards
wholly in the padded tail are skipped. On a multi-process mesh each rank
runs its shard of every global batch and all-gathers the results, so every
rank holds the whole batch. Files are byte-identical to the single-device
codec's.
"""

from __future__ import annotations

import collections
import contextlib
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vqvdb_tpu_torch.core.config import CodecConfig, LEAF_DIM, ModelConfig
from vqvdb_tpu_torch.core.weights import DeviceLike, params_from_jax
from vqvdb_tpu_torch.format.vqvdb import GridMetadata, VqvdbReader, VqvdbWriter
from vqvdb_tpu_torch.models.quantizer import rvq_dequantize, rvq_indices
from vqvdb_tpu_torch.models.vqvae import (
    check_tree,
    decoder_pre_tail,
    decoder_tail,
    decoder_tail_folded,
    encoder_apply,
    encoder_features,
    encoder_features_packed_down,
)
from vqvdb_tpu_torch.ops.packed import fold_strided_conv
from vqvdb_tpu_torch.ops.quantize import (
    fold_proj_into_scores,
    fused_dequantize,
    fused_nearest_indices,
    fused_score_argmin,
    prepare_codebook,
    prepare_scores,
)
from vqvdb_tpu_torch.ops.subpixel import fold_final_conv
from vqvdb_tpu_torch.ops.tail import apply_decoder_tail, fold_decoder_tail
from vqvdb_tpu_torch.parallel.distributed import all_gather_rows
from vqvdb_tpu_torch.parallel.mesh import Mesh, make_sharded_encode, replicate, shard_batch
from vqvdb_tpu_torch.runtime.native_io import copy_into
from vqvdb_tpu_torch.runtime.residual import RESIDUAL_MODES, apply_residual, quantize_residual
from vqvdb_tpu_torch.utils.errors import ModelMismatchError
from vqvdb_tpu_torch.utils.profiler import Profiler, span
from vqvdb_tpu_torch.vdb.grid import LeafGrid

PIPELINE_DEPTH = 2


@contextlib.contextmanager
def _writing(path, version: int, compression: str) -> Iterator[VqvdbWriter]:
    """A `VqvdbWriter` whose opening and closing are the trace range
    `host/file`."""
    with span("host/file"):
        w = VqvdbWriter(path, version=version, compression=compression)
    with w:
        yield w
        with span("host/file"):
            w.close()


class _Slot:
    """One device's host buffers of a pipeline stage (pinned on the card) and
    the event that marks its device->host copies done. Each buffer is given
    as (shape, (torch dtype, numpy dtype)): a u16 index buffer is int16 in
    torch, and `inp_dtype` / the `outs_np` views carry the numpy dtype."""

    def __init__(self, inp, outs, device: torch.device):
        self.device = device
        pin = device.type == "cuda"
        self.inp = torch.empty(inp[0], dtype=inp[1][0], pin_memory=pin)
        self.inp_dtype = np.dtype(inp[1][1])
        self.outs = [torch.empty(shape, dtype=dt[0], pin_memory=pin) for shape, dt in outs]
        self.outs_np = [t.numpy().view(dt[1]) for t, (_, dt) in zip(self.outs, outs)]
        self.done = torch.cuda.Event() if pin else None


class _Stage:
    """One pipeline stage: a `_Slot` per device, and with several local
    devices the host arrays (`whole`, given as the slots' outputs are) that
    their shards' rows are copied back into."""

    def __init__(self, slots: List[_Slot], whole=None):
        self.slots = slots
        self.whole = None if whole is None else [np.empty(shape, dt[1]) for shape, dt in whole]


class VQCodec:
    """Bidirectional streaming codec around a trained model.

    `params` is the JAX-layout tree of numpy arrays that
    `core.artifact.load_model` returns. It is converted to tensors on
    `device` (default `cuda`; without a card, pass `device="cpu"` or the
    constructor raises). The exact weight rewrites (folded decoder tail,
    folded projection scores and the score kernel's split operand, packed
    down conv) are computed once here. `profiler` (default: a new one)
    times the constructor's and each batch's stages (the module's
    docstring names them).
    """

    def __init__(self, params: Dict, model_config: ModelConfig,
                 codec_config: Optional[CodecConfig] = None,
                 device: DeviceLike = None, profiler: Optional[Profiler] = None,
                 mesh: Optional[Mesh] = None) -> None:
        self.mcfg = model_config
        self.ccfg = codec_config or CodecConfig()
        # Stage timers (host wall clock) of the construction and of the
        # pipelined batches: pass one to aggregate across codecs, or read
        # codec.profiler.report().
        self.profiler = profiler if profiler is not None else Profiler()
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device).type != mesh.devices[0].type:
                raise ValueError(f"device {device} is not the mesh's {mesh.devices[0]}")
            device = mesh.devices[0]
            mesh.shard_rows(self.ccfg.batch_size)  # ValueError unless it divides
        prof = self.profiler
        with prof("init/weights"):
            self.params = params_from_jax(params, model_config, device)
            check_tree(self.params, model_config)
            self.device = self.params["vq"]["embedding"].device
            self.dtype = self.ccfg.torch_dtype
            # The decode codebook is cast to the compute dtype before the lookup.
            self._codebook = self.params["vq"]["embedding"].to(self.dtype)
        self._folded_tail = self._folded_final = None
        if self.ccfg.fuse_decoder_tail or self.ccfg.fuse_final_conv:
            with prof("init/tail_fold"):
                if self.ccfg.fuse_decoder_tail:
                    self._folded_tail = fold_decoder_tail(self.params["decoder"],
                                                          self.mcfg)
                else:
                    fin = params["decoder"]["final"]
                    self._folded_final = {k: v.to(self.device) for k, v in fold_final_conv(
                        np.asarray(fin["w"]), np.asarray(fin["b"])).items()}
        # Residual-VQ needs the latent itself for its later stages, so the
        # projection folds into the scores only for a single-stage model.
        self._score_mc = None
        # What the score kernel takes instead of M or a codebook (M split
        # into bf16 terms in its shared-memory order), made once here: for
        # the folded scores, or else for each quantizer stage's codebook.
        self._score_prep = self._stage_prep = None
        with prof("init/score_operand"):
            if self.ccfg.fuse_proj_quantize and self.mcfg.num_quantizers == 1:
                proj = params["encoder"]["proj"]
                m, c = fold_proj_into_scores(
                    np.asarray(proj["w"]), np.asarray(proj["b"]),
                    self.params["vq"]["embedding"].cpu().numpy())
                self._score_mc = (m.to(self.device), c.to(self.device))
                self._score_prep = prepare_scores(*self._score_mc)
            else:
                books = self.params["vq"]["embedding"]
                self._stage_prep = [prepare_codebook(e) for e in
                                    (books if books.dim() == 3 else books[None])]
        # As in the JAX package, the packed down conv rides on the folded
        # projection's encode path.
        self._folded_down = None
        if (self.ccfg.pack_down_conv and self._score_mc is not None
                and self.mcfg.encoder_arch == "reference"):
            with prof("init/down_fold"):
                down = params["encoder"]["down"]
                self._folded_down = {
                    k: v.to(self.device) for k, v in fold_strided_conv(
                        np.asarray(down["w"]), np.asarray(down["b"])).items()}
        # What the device steps read, per device: on a mesh each local device
        # holds a copy of the first device's bits.
        consts = {"params": self.params, "codebook": self._codebook,
                  "folded_tail": self._folded_tail, "folded_final": self._folded_final,
                  "score_prep": self._score_prep, "stage_prep": self._stage_prep,
                  "folded_down": self._folded_down}
        self._consts = {self.device: consts}
        if mesh is not None:
            with prof("init/replicate"):
                for dev, rep in zip(mesh.devices, replicate(consts, mesh)):
                    self._consts.setdefault(dev, rep)
                mesh.synchronize()
        self._slots: Dict[str, list] = {}
        # (torch, numpy) dtypes of host index buffers: u8, or u16 as int16 bits
        self._host_idx = ((torch.uint8, np.uint8) if self.mcfg.num_embeddings <= 256
                          else (torch.int16, np.uint16))

    # -- device steps ----------------------------------------------------
    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder features before the folded projection, as the encode
        step takes them: [B,8,8,8,C] -> [B,4,4,4,F]."""
        r = self._consts[x.device]
        enc = r["params"]["encoder"]
        if r["folded_down"] is not None:
            return encoder_features_packed_down(
                enc, r["folded_down"], x, self.mcfg,
                fuse_rb16=self.ccfg.fuse_rb16)
        return encoder_features(enc, x, self.mcfg)

    @torch.inference_mode()
    def _encode_step(self, leaves: torch.Tensor) -> torch.Tensor:
        """[B,8,8,8,C] f32 -> [B,4,4,4] (or [B,4,4,4,S] residual-VQ) indices:
        uint8 for K <= 256, else int32; on the leaves' device."""
        r = self._consts[leaves.device]
        x = leaves.to(self.dtype)
        b = x.shape[0]
        fused = r["score_prep"] is not None
        with span("encode/features"):
            h = self._features(x) if fused else encoder_apply(r["params"]["encoder"], x,
                                                              self.mcfg)
        with span("encode/score_argmin" if fused else "encode/quantize"):
            if fused:
                idx = fused_score_argmin(h.reshape(-1, h.shape[-1]), r["score_prep"])
            else:
                flat = h.reshape(-1, self.mcfg.embedding_dim).to(torch.float32)
                if self.mcfg.num_quantizers > 1:
                    idx = rvq_indices(flat, r["params"]["vq"]["embedding"], r["stage_prep"])
                else:
                    idx = fused_nearest_indices(flat, r["stage_prep"][0])
            idx = idx.reshape((b,) + self.mcfg.index_shape)
            return idx.to(torch.uint8) if self.mcfg.num_embeddings <= 256 else idx

    @torch.inference_mode()
    def _decode_step(self, indices: torch.Tensor) -> torch.Tensor:
        """[B,4,4,4] (or [B,4,4,4,S] residual-VQ) uint8 or int32 indices ->
        [B,8,8,8,C] f32, on the indices' device."""
        r = self._consts[indices.device]
        b = indices.shape[0]
        with span("decode/dequantize"):
            if self.mcfg.num_quantizers > 1:
                z = rvq_dequantize(indices.reshape(-1, self.mcfg.num_quantizers),
                                   r["codebook"])
            else:
                z = fused_dequantize(indices.reshape(-1), r["codebook"])
            z = z.reshape((b,) + self.mcfg.latent_shape + (self.mcfg.embedding_dim,))
        dec = r["params"]["decoder"]
        h = decoder_pre_tail(dec, z, self.mcfg)
        if r["folded_tail"] is not None:
            return apply_decoder_tail(r["folded_tail"], h, self.mcfg)
        if r["folded_final"] is not None:
            return decoder_tail_folded(dec["up_conv"], r["folded_final"], h, self.mcfg)
        return decoder_tail(dec, h, self.mcfg)

    # -- latent-shape self-check -----------------------------------------
    def check_latent_shape(self) -> Tuple[int, ...]:
        """Run zero leaves through the encoder, one per shard of the mesh
        (one without a mesh); the index shape must match the config."""
        n = 1 if self.mesh is None else self.mesh.size
        probe = np.zeros((n, LEAF_DIM, LEAF_DIM, LEAF_DIM, self.mcfg.in_channels),
                         np.float32)
        if self.mesh is None:
            out = self._encode_step(torch.from_numpy(probe).to(self.device))
        else:
            (out, *_) = make_sharded_encode(self.mesh, self, replicate_out=True)(
                shard_batch(probe, self.mesh))
        got = tuple(out.shape[1:])
        if got != self.mcfg.index_shape:
            raise ModelMismatchError(
                f"latent-shape probe mismatch: model produced {got}, "
                f"config declares {self.mcfg.index_shape}")
        return got

    # -- pipelined batches -----------------------------------------------
    def _slots_for(self, kind: str) -> List["_Stage"]:
        if kind not in self._slots:
            bs = self.ccfg.batch_size
            mesh = self.mesh
            rows_in = bs if mesh is None else mesh.shard_rows(bs)
            # A multi-process mesh gathers the whole batch onto each rank.
            rows_out = bs if mesh is None or mesh.multiprocess else rows_in

            def leaf(n):
                return ((n, LEAF_DIM, LEAF_DIM, LEAF_DIM, self.mcfg.in_channels),
                        (torch.float32, np.float32))

            def idx(n):
                return ((n,) + self.mcfg.index_shape, self._host_idx)

            inp, outs = {"encode": (leaf(rows_in), [idx(rows_out)]),
                         "decode": (idx(rows_in), [leaf(rows_out)]),
                         "residual": (leaf(rows_in), [idx(rows_out), leaf(rows_out)])}[kind]
            devices = [self.device] if mesh is None else list(mesh.devices)
            # The shards of one process's devices come back into a host batch
            # (one device's shard, or a gathered batch, is the batch itself).
            whole = None
            if mesh is not None and mesh.local_size > 1:
                whole = [((bs,) + shape[1:], dt) for shape, dt in outs]
            self._slots[kind] = [_Stage([_Slot(inp, outs, d) for d in devices], whole)
                                 for _ in range(PIPELINE_DEPTH)]
        return self._slots[kind]

    def _steps(self, kind: str, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """A staged batch (or shard) through the device step(s) of `kind`:
        "encode" (leaves -> indices), "decode" (indices -> leaves) or
        "residual" (leaves -> indices, and those indices, still on the
        device, through the decode step as `decompress` runs it). On a
        multi-process mesh each output is all-gathered over the group. Index
        outputs stay in the step's dtype: `_read_back`'s copy takes them to
        the host buffers' (u8, or u16 as int16 bits)."""
        mesh = self.mesh
        group = mesh.group if mesh is not None and mesh.multiprocess else None

        def gather(t):
            return all_gather_rows(t, group)

        if kind == "decode":
            if x.dtype == torch.int16:  # u16 bits
                x = x.to(torch.int32) & 0xFFFF
            return (gather(self._decode_step(x)),)
        idx = self._encode_step(x)
        host = gather(idx)
        return (host,) if kind == "encode" else (host, gather(self._decode_step(idx)))

    def _pipelined(self, kind: str, batches: Iterable[Tuple[np.ndarray, object]]
                   ) -> Iterator[Tuple[List[np.ndarray], object, int]]:
        """Run each (host batch of <= batch_size rows, tag) through the
        device steps of `kind` (`_steps`); yields (host result rows per
        output, tag, n). A yielded array is a view of a reused buffer: use
        it before the next one. On a mesh local device j takes rows
        [(first_shard + j) * B/size, ...) of the padded batch on its own
        stream; a shard wholly past the batch's rows is not run, except on a
        multi-process mesh, whose ranks all take part in each gather."""
        stages = self._slots_for(kind)
        mesh = self.mesh
        per = self.ccfg.batch_size if mesh is None else mesh.shard_rows(self.ccfg.batch_size)
        first = 0 if mesh is None else mesh.first_shard
        every = mesh is not None and mesh.multiprocess
        pending: collections.deque = collections.deque()
        dispatched = 0

        def collect(item):
            with self.profiler("device/readback_wait"):
                return self._collect(item)

        for chunk, tag in batches:
            n = chunk.shape[0]
            if n == 0:
                continue
            # A stage is reused only after _collect has waited on its events.
            stage = stages[dispatched % PIPELINE_DEPTH]
            dispatched += 1
            with self.profiler("host/stage_in"):
                src = np.ascontiguousarray(chunk, stage.slots[0].inp_dtype)
                if not src.flags.writeable:  # a frame read from a file
                    src = src.copy()
                src = torch.from_numpy(src.view(np.int16) if src.dtype == np.uint16 else src)
                live = []
                for j, slot in enumerate(stage.slots):
                    r0 = (first + j) * per
                    rows = max(0, min(per, n - r0))
                    if rows or every:
                        # torch copies (in threads) what numpy would copy in one
                        slot.inp[:rows].copy_(src[r0:r0 + rows])
                        live.append((j, slot, r0, rows))
            if any(rows < per for _, _, _, rows in live):
                with self.profiler("host/pad"):
                    for _, slot, _, rows in live:
                        slot.inp[rows:].zero_()
            with self.profiler("device/dispatch"):
                for j, slot, _, _ in live:
                    with (mesh.stream(j) if mesh is not None else contextlib.nullcontext()):
                        dev = slot.device
                        self._read_back(slot, self._steps(
                            kind, slot.inp.to(dev, non_blocking=True)))
            pending.append((stage, live, tag, n))
            if len(pending) >= PIPELINE_DEPTH:
                yield collect(pending.popleft())
        while pending:
            yield collect(pending.popleft())

    @staticmethod
    def _read_back(slot: _Slot, results: Sequence[torch.Tensor]) -> None:
        """Enqueue the copies of one device's step results into its slot's
        host buffers, in their dtype (from the card: asynchronous, into
        pinned memory, the slot's event recorded after them); `_collect`
        takes them."""
        cuda = slot.done is not None
        with span("device/read_back"):
            for out, res in zip(slot.outs, results):
                out.copy_(res, non_blocking=cuda)
            if cuda:
                slot.done.record()

    @staticmethod
    def _collect(item) -> Tuple[List[np.ndarray], object, int]:
        stage, live, tag, n = item
        for _, slot, _, _ in live:
            if slot.done is not None:
                slot.done.synchronize()
        if stage.whole is None:  # one slot holds the batch
            return [a[:n] for a in live[0][1].outs_np], tag, n
        for _, slot, r0, rows in live:
            for dst, got in zip(stage.whole, slot.outs_np):
                # One thread: on an 8-core H100 host, the hardware's count of
                # threads spawned per copy took 2.6x one thread's time for an
                # 8 MiB batch (chip_smoke.py phase 16 times it: PERF.md).
                copy_into(dst[r0:r0 + rows], got[:rows], threads=1)
        return [a[:n] for a in stage.whole], tag, n

    def _batches(self, data: np.ndarray):
        bs = self.ccfg.batch_size
        for s in range(0, data.shape[0], bs):
            yield data[s: s + bs], s

    # -- array-level API -------------------------------------------------
    def encode_leaves(self, leaves: np.ndarray) -> np.ndarray:
        """Encode [N,8,8,8,C] (or [N,8,8,8]) f32 -> [N,4,4,4] indices
        ([N,4,4,4,S] residual-VQ), u8 or u16 by the model's index dtype."""
        leaves = np.asarray(leaves, np.float32)
        if leaves.ndim == 4:
            leaves = leaves[..., None]
        out = np.empty((leaves.shape[0],) + self.mcfg.index_shape,
                       self.mcfg.index_dtype)
        for (rows,), s, n in self._pipelined("encode", self._batches(leaves)):
            out[s: s + n] = rows
        return out

    def decode_indices(self, indices: np.ndarray) -> np.ndarray:
        """Decode [N,4,4,4] (or [N,4,4,4,S]) u8 / u16 indices ->
        [N,8,8,8,C] f32, batched."""
        indices = np.asarray(indices, self.mcfg.index_dtype)
        out = np.empty((indices.shape[0], LEAF_DIM, LEAF_DIM, LEAF_DIM,
                        self.mcfg.in_channels), np.float32)
        for (rows,), s, n in self._pipelined("decode", self._batches(indices)):
            out[s: s + n] = rows
        return out

    # -- file-level API --------------------------------------------------
    def _resolve_format(self, format_version: Optional[int], residual: Optional[str],
                        residual_tol: Optional[float]) -> int:
        """Option checks and the format default shared by compress and
        compress_stream (whose files must be byte-identical): a residual
        forces v6; otherwise v3, or v4 when K > 256."""
        if residual is not None:
            if residual not in RESIDUAL_MODES:
                raise ValueError(f"unknown residual mode {residual!r}")
            if residual_tol is not None and residual != "int8":
                raise ValueError("residual_tol applies to the int8 mode only")
            if format_version is None:
                format_version = 6
            elif format_version != 6:
                raise ValueError("residual correction requires format version 6")
        if format_version is None:
            format_version = 3 if self.mcfg.num_embeddings <= 256 else 4
        return format_version

    def _grid_meta(self, name: str, total_blocks: int, transform, channels: int,
                   residual: Optional[str]) -> GridMetadata:
        return GridMetadata(
            name=name, num_embeddings=self.mcfg.num_embeddings,
            latent_shape=self.mcfg.index_shape, total_blocks=total_blocks,
            transform=transform,
            residual_mode=0 if residual is None else {"int8": 1, "f16": 2}[residual],
            residual_channels=0 if residual is None else channels)

    @staticmethod
    def _write_rows(w: VqvdbWriter, outs, origins, leaves, residual, residual_tol,
                    host: Dict[str, float]) -> None:
        """One batch of encode results into the file; with a residual, the
        error of the decoded rows against `leaves` is quantized first. The
        host seconds of each part accumulate in `host`."""
        t0 = time.perf_counter()
        scales = q = None
        if residual is not None:
            scales, q = quantize_residual(leaves - outs[1], residual, residual_tol)
        t1 = time.perf_counter()
        with span("host/write_frames"):
            w.write_batch(outs[0], origins, scales, q)
        host["quantize_residual"] += t1 - t0
        host["write_frames"] += time.perf_counter() - t1

    @staticmethod
    def _stats(total: int, t0: float, host: Dict[str, float]) -> dict:
        dt = time.perf_counter() - t0
        return {"leaves": total, "seconds": dt,
                "leaves_per_sec": total / dt if dt > 0 else float("inf"),
                "host_seconds": host}

    def compress(
        self,
        grids: Union[LeafGrid, Sequence[LeafGrid]],
        out_path: Union[str, Path],
        *,
        progress: bool = False,
        format_version: Optional[int] = None,
        compression: str = "zlib",
        residual: Optional[str] = None,
        residual_tol: Optional[float] = None,
        should_stop: Optional[Callable[[], bool]] = None,
    ) -> dict:
        """Encode grids and stream them to a `.vqvdb` file.

        format_version: 3 (default for K <= 256), 4 (default beyond), 5 or 6.
        compression: the v5/v6 frame codec (zlib, lzma or lz4; ignored for
            v3/v4).
        residual ("int8" | "f16" | None): the v6 near-lossless tier. Each
            batch's indices also run through the decode step, and the error
            of that reconstruction is quantized and stored beside them
            (`runtime/residual.py`); forces v6. residual_tol (int8) floors
            the step at 2*tol.
        should_stop (checked between batches) requests a graceful abort:
            batches written so far are kept, the open grid's block count is
            patched (VqvdbWriter.abort_grid), later grids are skipped, and
            the stats say "aborted": True.
        Returns {leaves, seconds, leaves_per_sec, host_seconds, bytes,
        aborted}; host_seconds splits the host's residual quantization and
        frame writing (compression included) from the rest.
        """
        if isinstance(grids, LeafGrid):
            grids = [grids]
        format_version = self._resolve_format(format_version, residual, residual_tol)
        stop = should_stop if should_stop is not None else (lambda: False)
        kind = "encode" if residual is None else "residual"
        host = {"quantize_residual": 0.0, "write_frames": 0.0}
        aborted = False
        t0 = time.perf_counter()
        total = 0
        with _writing(out_path, format_version, compression) as w:
            for grid in grids:
                if aborted:
                    break
                w.start_grid(self._grid_meta(grid.name, grid.num_leaves, grid.transform,
                                             grid.channels, residual))
                for outs, s, n in self._pipelined(kind, self._batches(grid.leaves)):
                    if stop():
                        aborted = True
                        break
                    self._write_rows(w, outs, grid.origins[s: s + n],
                                     grid.leaves[s: s + n], residual, residual_tol, host)
                    total += n
                    if progress:
                        print(f"[compress] {grid.name}: {s + n}/{grid.num_leaves}")
                w.abort_grid() if aborted else w.end_grid()
        stats = self._stats(total, t0, host)
        stats.update(bytes=Path(out_path).stat().st_size, aborted=aborted)
        return stats

    def compress_stream(
        self,
        streams,
        out_path: Union[str, Path],
        *,
        progress: bool = False,
        format_version: Optional[int] = None,
        compression: str = "zlib",
        residual: Optional[str] = None,
        residual_tol: Optional[float] = None,
        should_stop: Optional[Callable[[], bool]] = None,
    ) -> dict:
        """`compress` from lazily read leaf streams, holding O(batch) leaves.

        `streams` is one object or a sequence of objects with .name,
        .transform, .num_leaves, .channels, .origins [N,3] and
        .leaf_batches(batch_size) -> iterator of [n,8,8,8,C] f32 arrays of
        any n. They are re-chunked to full batches, so a stream of a grid's
        leaves writes the file that `compress` of the grid writes, byte for
        byte. should_stop is checked before each batch is dispatched; the
        batches in flight are still written."""
        if not isinstance(streams, (list, tuple)):
            streams = [streams]
        format_version = self._resolve_format(format_version, residual, residual_tol)
        stop = should_stop if should_stop is not None else (lambda: False)
        kind = "encode" if residual is None else "residual"
        host = {"quantize_residual": 0.0, "write_frames": 0.0}
        bs = self.ccfg.batch_size
        aborted = False
        t0 = time.perf_counter()
        total = 0

        def rechunk(it):
            """Arrays of any length -> exact-bs chunks (and a ragged tail),
            holding at most one extra batch."""
            buf, have = [], 0
            for a in it:
                if not a.shape[0]:
                    continue
                buf.append(np.asarray(a, np.float32))
                have += a.shape[0]
                while have >= bs:
                    cat = np.concatenate(buf) if len(buf) > 1 else buf[0]
                    yield cat[:bs]
                    rest = cat[bs:]
                    buf, have = ([rest] if rest.shape[0] else []), rest.shape[0]
            if have:
                yield np.concatenate(buf) if len(buf) > 1 else buf[0]

        with _writing(out_path, format_version, compression) as w:
            for stream in streams:
                if aborted:
                    break
                w.start_grid(self._grid_meta(stream.name, stream.num_leaves,
                                             np.asarray(stream.transform, np.float32),
                                             stream.channels, residual))
                cursor = 0

                def batches(stream=stream):
                    nonlocal aborted, cursor
                    for chunk in rechunk(stream.leaf_batches(bs)):
                        if stop():
                            aborted = True
                            return
                        org = stream.origins[cursor: cursor + chunk.shape[0]]
                        cursor += chunk.shape[0]
                        yield chunk, (org, chunk)

                for outs, (org, chunk), n in self._pipelined(kind, batches()):
                    self._write_rows(w, outs, org, chunk, residual, residual_tol, host)
                    total += n
                    if progress:
                        print(f"[compress] {stream.name}: {total} leaves")
                if aborted:
                    w.abort_grid()
                    continue
                if cursor != stream.num_leaves:
                    raise ValueError(f"stream '{stream.name}' yielded {cursor} leaves, "
                                     f"declared {stream.num_leaves}")
                w.end_grid()
        stats = self._stats(total, t0, host)
        stats.update(bytes=Path(out_path).stat().st_size, aborted=aborted)
        return stats

    def _decode_stream_host(self, in_path: Union[str, Path], grids, bbox,
                            host: Dict[str, float]):
        """decode_stream's core: yields (grid metadata, decoded rows [n,...]
        as a view of a reused pinned buffer, origins, n, scales, residual)
        per full batch of the selection. scales / residual are None for
        grids without residuals; the host seconds spent reading (and
        decompressing) frames accumulate in host["read_frames"]."""
        names = None
        if grids is not None:
            names = {grids} if isinstance(grids, str) else set(grids)
        lo = hi = None
        if bbox is not None:
            lo = np.asarray(bbox[0], np.int64).reshape(3)
            hi = np.asarray(bbox[1], np.int64).reshape(3)
        bs = self.ccfg.batch_size
        with span("host/file"):
            r = VqvdbReader(in_path)
        with r:
            if r.num_embeddings != self.mcfg.num_embeddings:
                raise ModelMismatchError(
                    f"file has {r.num_embeddings} embeddings, model has "
                    f"{self.mcfg.num_embeddings}")

            def read():
                t0 = time.perf_counter()
                with span("host/read_frames"):
                    got = r.next_batch_residual(bs)
                host["read_frames"] += time.perf_counter() - t0
                return got

            def batches():
                """Full batches of the selected leaves, grid by grid; the
                host arrays (origins, scales, residual) ride along as the
                tag, filtered and regrouped with the indices."""
                while r.has_next_grid():
                    meta = r.next_grid_metadata()
                    if names is not None and meta.name not in names:
                        r.skip_grid_payload()
                        continue
                    if tuple(meta.latent_shape) != self.mcfg.index_shape:
                        raise ModelMismatchError(
                            f"file latent shape {meta.latent_shape} != model "
                            f"{self.mcfg.index_shape}")
                    if meta.residual_mode and meta.residual_channels != self.mcfg.in_channels:
                        raise ModelMismatchError(
                            f"file residual stream has {meta.residual_channels} "
                            f"channels, model decodes {self.mcfg.in_channels}")
                    carry = None
                    while r.has_next():
                        idx, *hosts = read()
                        if lo is not None:
                            keep = (np.all(hosts[0] < hi, axis=1)
                                    & np.all(hosts[0] + LEAF_DIM > lo, axis=1))
                            idx = idx[keep]
                            hosts = [None if h is None else h[keep] for h in hosts]
                            if idx.shape[0] == 0:
                                continue
                        if carry is not None:
                            idx = np.concatenate([carry[0], idx])
                            hosts = [None if a is None else np.concatenate([a, b])
                                     for a, b in zip(carry[1], hosts)]
                            carry = None
                        while idx.shape[0] >= bs:
                            yield idx[:bs], (meta, *[None if h is None else h[:bs]
                                                     for h in hosts])
                            idx = idx[bs:]
                            hosts = [None if h is None else h[bs:] for h in hosts]
                        if idx.shape[0]:
                            carry = (idx, hosts)
                    if carry is not None:
                        yield carry[0], (meta, *carry[1])

            for (rows,), (meta, org, sc, res), n in self._pipelined("decode", batches()):
                yield meta, rows, org, n, sc, res

    def decode_stream(self, in_path: Union[str, Path], *, grids=None, bbox=None):
        """Memory-bounded streaming decode: yields (grid metadata, leaves
        [n,8,8,8,C] f32, origins [n,3] i32) per batch, arrays the caller
        owns. Only O(batch_size) leaves are resident at once.

        grids: a name or iterable of names; other grids' payloads are
            skipped on disk without decompression or decoding.
        bbox: voxel-space ((x0,y0,z0),(x1,y1,z1)), lower inclusive, upper
            exclusive; only leaves intersecting the box are decoded, re-packed
            into full device batches.
        v6 residual grids are corrected on the host (`runtime/residual.py`).
        """
        host = {"read_frames": 0.0}
        for meta, rows, org, n, sc, res in self._decode_stream_host(in_path, grids, bbox,
                                                                    host):
            leaves = rows.copy()
            apply_residual(leaves, sc, res)
            yield meta, leaves, org

    def decompress(self, in_path: Union[str, Path], *, progress: bool = False,
                   grids=None, bbox=None) -> Tuple[List[LeafGrid], dict]:
        """Decode a `.vqvdb` file (v3 to v6) into LeafGrids; `grids` / `bbox`
        select as in `decode_stream`, and a grid with nothing selected is
        left out. Returns (grids, {leaves, seconds, leaves_per_sec,
        host_seconds}); host_seconds splits frame reading (decompression
        included) and the v6 correction from the rest."""
        t0 = time.perf_counter()
        host = {"read_frames": 0.0, "apply_residual": 0.0}
        out_grids: List[LeafGrid] = []
        total = cursor = 0
        cur_meta = leaves_out = origins_out = None
        blk = (LEAF_DIM, LEAF_DIM, LEAF_DIM, self.mcfg.in_channels)

        def finish():
            if cur_meta is not None:
                out_grids.append(LeafGrid(name=cur_meta.name, origins=origins_out[:cursor],
                                          leaves=leaves_out[:cursor],
                                          transform=cur_meta.transform))

        for meta, rows, origins, n, sc, res in self._decode_stream_host(in_path, grids,
                                                                        bbox, host):
            with self.profiler("host/scatter"):
                if meta is not cur_meta:
                    finish()
                    cur_meta, cursor = meta, 0
                    # total_blocks over-allocates under a bbox selection; finish()
                    # keeps what was decoded.
                    leaves_out = np.empty((meta.total_blocks,) + blk, np.float32)
                    origins_out = np.empty((meta.total_blocks, 3), np.int32)
                    if progress:
                        print(f"[decompress] {meta.name}: {meta.total_blocks} leaves")
                dst = leaves_out[cursor: cursor + n]
                dst[...] = rows
                origins_out[cursor: cursor + n] = origins
            t1 = time.perf_counter()
            apply_residual(dst, sc, res)
            host["apply_residual"] += time.perf_counter() - t1
            cursor += n
            total += n
        with self.profiler("host/scatter"):
            finish()
        return out_grids, self._stats(total, t0, host)
