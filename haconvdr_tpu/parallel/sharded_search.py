"""Cross-device sharded exact top-k search.

Replacement for faiss's GPU index sharding
(``GpuMultipleClonerOptions.shard = True``,
src/test_HAConvDR_topiocqa.py:55-66): the passage-embedding matrix is
sharded along the passage axis across every device of the mesh; each
device runs the exact top-k over its resident shard
(ops/topk.search_block) and the per-shard candidate lists are merged ON DEVICE with
an ``all_gather`` + ``lax.top_k`` — replacing both faiss's internal
cross-GPU reduction and the reference's host 2-pointer block merge
(":131-149").
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from haconvdr_tpu.ops.topk import search_block


def _flat_mesh(mesh: Mesh) -> Mesh:
    """View an N-d mesh as one linear 'd' axis for passage sharding."""
    return Mesh(mesh.devices.reshape(-1), ("d",))


def sharded_topk(
    mesh: Mesh,
    queries: jax.Array,  # [Q, D] replicated
    passages: jax.Array,  # [Ntot, D] sharded on axis 0 over the flat mesh
    n_valid: int,  # true passage count before padding
    k: int,
    chunk: int,
    scales: Optional[jax.Array] = None,  # [n_shards, D] per-shard dequant
) -> Tuple[jax.Array, jax.Array]:
    """Replicated ([Q, k] scores, [Q, k] global offsets) over all shards.

    ``scales`` (int8 indexes, index/quantize.py): each shard folds its own
    per-dim dequantization scale into the replicated queries before they
    are quantised per query (ops/topk.quantize_queries)."""
    fmesh = _flat_mesh(mesh)
    n_shards = fmesh.devices.size
    Ntot = passages.shape[0]
    assert Ntot % n_shards == 0, "pad the passage axis to the shard count"
    shard_rows = Ntot // n_shards

    def local_search(q, p_shard, *rest):
        shard_id = jax.lax.axis_index("d")
        base = shard_id * shard_rows
        if rest:  # fold this shard's dequant scale into the queries
            q = q.astype(jnp.float32) * rest[0][shard_id]
        # valid rows in this shard given global n_valid
        local_valid = jnp.clip(n_valid - base, 0, shard_rows)
        s, i = search_block(q, p_shard, local_valid.astype(jnp.int32), k, chunk)
        gi = jnp.where(i >= 0, i + base, -1)
        # gather every shard's candidates and reduce on device
        sg = jax.lax.all_gather(s, "d")  # [n_shards, Q, k]
        ig = jax.lax.all_gather(gi, "d")
        sg = jnp.moveaxis(sg, 0, 1).reshape(q.shape[0], n_shards * k)
        ig = jnp.moveaxis(ig, 0, 1).reshape(q.shape[0], n_shards * k)
        best_s, pos = jax.lax.top_k(sg, k)
        best_i = jnp.take_along_axis(ig, pos, axis=1)
        return best_s, best_i

    in_specs = (P(), P("d", None)) + ((P(),) if scales is not None else ())
    args = (queries, passages) + ((scales,) if scales is not None else ())
    fn = jax.shard_map(
        local_search,
        mesh=fmesh,
        in_specs=in_specs,
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(*args)


class ShardedIndex:
    """A device-resident, device-sharded flat inner-product index.

    Equivalent of ``build_faiss_index`` + ``index.add`` for one resident
    block set (src/test_HAConvDR_topiocqa.py:39-71,98): embeddings are
    placed shard-by-shard across the mesh once, then searched many times.
    For corpora larger than total device memory, callers hold several
    ShardedIndex blocks and merge results via ops.topk.merge_topk (the
    BlockSearcher pattern), or shrink the resident bytes with
    ``dtype="bfloat16"`` (2x) or ``dtype="int8"`` (4x; per-shard scalar
    quantization, index/quantize.py).
    """

    def __init__(
        self,
        mesh: Mesh,
        embeddings: np.ndarray,  # [N, D]
        ids: Optional[np.ndarray] = None,  # [N] global offsets/pids
        chunk: int = 65536,
        dtype: str = "float32",
    ):
        self.mesh = mesh
        fmesh = _flat_mesh(mesh)
        n_shards = fmesh.devices.size
        self.n_valid = embeddings.shape[0]
        rows = -(-self.n_valid // n_shards) * n_shards
        # per-shard chunk granularity: pad shard rows to chunk multiple
        shard_rows = rows // n_shards
        shard_rows = -(-shard_rows // chunk) * chunk
        rows = shard_rows * n_shards
        if rows != embeddings.shape[0]:
            pad = np.zeros((rows - self.n_valid, embeddings.shape[1]), embeddings.dtype)
            embeddings = np.concatenate([embeddings, pad], axis=0)
        self.chunk = chunk
        sharding = NamedSharding(fmesh, P("d", None))
        if jnp.dtype(dtype) == jnp.int8:
            from haconvdr_tpu.index.quantize import quantize_int8

            parts, scales = [], []
            for s in range(n_shards):
                qb, sc = quantize_int8(embeddings[s * shard_rows : (s + 1) * shard_rows])
                parts.append(qb)
                scales.append(sc)
            embeddings = np.concatenate(parts, axis=0)
            self.scales = jnp.asarray(np.stack(scales))  # [n_shards, D] f32
        else:
            self.scales = None
        self.passages = jax.device_put(
            jnp.asarray(embeddings, jnp.dtype(dtype)), sharding
        )
        self.ids = None if ids is None else np.asarray(ids)
        self._jits = {}

    def _search(self, queries, passages, k):
        # one jitted program per k (retracing shard_map per call is costly)
        if k not in self._jits:
            self._jits[k] = jax.jit(
                functools.partial(
                    sharded_topk, self.mesh, n_valid=self.n_valid,
                    chunk=self.chunk, k=k,
                )
            )
        if self.scales is not None:
            return self._jits[k](queries, passages, scales=self.scales)
        return self._jits[k](queries, passages)

    @classmethod
    def from_store(
        cls,
        mesh: Mesh,
        store,
        chunk: int = 65536,
        dtype: str = "float32",
        num_blocks: int = -1,
    ) -> "ShardedIndex":
        """Build a device-resident sharded index straight from an
        EmbeddingBlockStore without assembling the corpus on one host
        buffer: each shard's rows are placed on its device as they are cut
        out of the block stream, then stitched into one global jax.Array
        (the replacement for faiss's GpuMultipleClonerOptions shard clone,
        src/test_HAConvDR_topiocqa.py:54-67).

        Memory plan: a 54.6M x 768 corpus is 167.6 GB in f32, 83.8 GB in
        bfloat16 and 41.9 GB as an int8 index (dtype="int8",
        index/quantize.py: per-shard per-dim scales).  Corpora that exceed
        the mesh's device memory use the streaming BlockSearcher instead.

        Sizing uses ``store.block_size`` (npy header / embid pickle), so
        each block's embedding matrix is streamed from disk exactly once.
        """
        import jax as _jax

        nb = store.num_blocks() if num_blocks < 0 else num_blocks
        sizes = [store.block_size(b) for b in range(nb)]
        n_valid = int(sum(sizes))

        fmesh = _flat_mesh(mesh)
        devices = list(fmesh.devices.reshape(-1))
        n_shards = len(devices)
        shard_rows = -(-n_valid // n_shards)
        shard_rows = -(-shard_rows // chunk) * chunk
        rows = shard_rows * n_shards

        jdt = jnp.dtype(dtype)
        is_int8 = jdt == jnp.int8
        buf_dt = np.float32 if is_int8 else jdt
        if is_int8:
            from haconvdr_tpu.index.quantize import quantize_int8

        scales = []

        def place(buf, dev):
            if is_int8:
                qb, sc = quantize_int8(buf)
                scales.append(sc)
                return _jax.device_put(qb, dev)
            return _jax.device_put(buf, dev)

        ids_all = np.empty((n_valid,), np.int64)
        shard_arrays = []
        shard_buf = None  # allocated at first block (dim known then)
        shard_fill = 0
        shard_id = 0
        row = 0
        dim = None
        for b in range(nb):
            emb, ids = store.read_block(b)
            blk_scale = store.block_scale(b)
            if blk_scale is not None:  # int8-quantized block: reconstruct
                from haconvdr_tpu.index.quantize import dequantize_int8

                emb = dequantize_int8(np.asarray(emb), blk_scale)
            if shard_buf is None:
                dim = emb.shape[1]
                shard_buf = np.zeros((shard_rows, dim), buf_dt)
            ids_all[row : row + emb.shape[0]] = ids
            row += emb.shape[0]
            off = 0
            while off < emb.shape[0]:
                take = min(shard_rows - shard_fill, emb.shape[0] - off)
                shard_buf[shard_fill : shard_fill + take] = emb[off : off + take]
                shard_fill += take
                off += take
                if shard_fill == shard_rows:
                    shard_arrays.append(place(shard_buf, devices[shard_id]))
                    shard_id += 1
                    shard_fill = 0
                    if shard_id < n_shards:
                        shard_buf = np.zeros((shard_rows, dim), buf_dt)
        if shard_fill > 0 or shard_id < n_shards:
            shard_buf[shard_fill:] = 0
            shard_arrays.append(place(shard_buf, devices[shard_id]))
            shard_id += 1
            while shard_id < n_shards:
                shard_arrays.append(
                    place(np.zeros((shard_rows, dim), buf_dt), devices[shard_id])
                )
                shard_id += 1

        sharding = NamedSharding(fmesh, P("d", None))
        global_arr = _jax.make_array_from_single_device_arrays(
            (rows, dim), sharding, shard_arrays
        )
        obj = cls.__new__(cls)
        obj.mesh = mesh
        obj.n_valid = n_valid
        obj.chunk = chunk
        obj.passages = global_arr
        obj.scales = jnp.asarray(np.stack(scales)) if is_int8 else None
        obj.ids = ids_all
        obj._jits = {}
        return obj

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores [Q, k], ids [Q, k]).  ``ids`` are global ids when
        an id array was provided, else raw row offsets."""
        Q = queries.shape[0]
        queries = np.asarray(queries)
        # int8 index: queries stay float (per-shard dequant scales fold in
        # under the shard_map before per-query quantisation)
        q_dtype = jnp.float32 if self.scales is not None else self.passages.dtype
        q = jnp.asarray(queries, q_dtype)
        s, i = self._search(q, self.passages, k)
        s, i = np.asarray(s)[:Q], np.asarray(i)[:Q]
        if self.ids is not None:
            safe = np.clip(i, 0, self.n_valid - 1)
            i = np.where(i >= 0, self.ids[safe], -1)
        return s, i
