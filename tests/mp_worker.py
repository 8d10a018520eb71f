"""Worker for the real multi-process (multi-controller) tests
(tests/test_multiprocess.py) — run as `python mp_worker.py <mode> <pid>
<nproc> <port> <tmpdir>` under `jax.distributed.initialize` on localhost
CPU.  Exercises the `jax.process_count() > 1` semantics that the
in-process virtual-mesh suite cannot: per-process addressable shards,
cross-process barriers, per-process block visibility.

Reference analog: the torch.distributed scaffolding the reference ships
but never tests (/root/reference/src/utils.py:173-228 barrier_array_merge,
:133-147 rank-mod StreamingDataset).

Not collected by pytest (no test_ prefix).  Asserts internally; exit code
0 = all checks passed in this process.
"""

import os
import sys


def _init(pid: int, nproc: int, port: str):
    import jax

    # config.update works because no backend has been initialized in a
    # fresh interpreter
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.process_index() == pid
    return jax


def run_ivf(pid: int, nproc: int, port: str, tmpdir: str) -> None:
    """Build a 2-process global-mesh IVFIndex, persist it with
    save_ivf_sharded (each process writes its own shards — the path that
    was a NotImplementedError guard through round 4), reload it with
    load_ivf_sharded on the same mesh, and assert this process's
    addressable shards round-trip exactly."""
    jax = _init(pid, nproc, port)
    import jax.numpy as jnp  # noqa: F401
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from haconvdr_tpu.parallel.sharded_ivf import (
        IVFIndex,
        load_ivf_sharded,
        save_ivf_sharded,
    )

    devices = sorted(jax.devices(), key=lambda d: d.id)
    assert len(devices) == nproc  # 1 CPU device per process
    mesh = Mesh(np.array(devices), ("d",))

    # ground truth generated identically in every process AND in the main
    # pytest process (tests/test_multiprocess.py) from the same seed
    rs = np.random.RandomState(0)
    nlist, cap, D, R = 8, 4, 16, 6
    buckets = rs.randn(nlist, cap, D).astype(np.float32)
    bucket_ids = rs.permutation(nlist * cap).astype(np.int32).reshape(
        nlist, cap
    )
    bucket_ids[0, 2:] = -1  # some empty slots (pad rows)
    tail = rs.randn(R, D).astype(np.float32)
    tail_ids = (1000 + np.arange(R)).astype(np.int32)
    centroids = rs.randn(nlist, D).astype(np.float32)

    def gshard(x, spec):
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    index = IVFIndex(
        centroids=jax.device_put(centroids, NamedSharding(mesh, P())),
        buckets=gshard(buckets, P("d", None, None)),
        bucket_ids=gshard(bucket_ids, P("d", None)),
        tail=gshard(tail, P("d", None)),
        tail_ids=gshard(tail_ids, P("d")),
        nprobe=4,
    )
    out = os.path.join(tmpdir, "ivf_mp")
    save_ivf_sharded(index, out)  # barriers internally; all files complete

    idx2, meta = load_ivf_sharded(mesh, out, with_meta=True)
    assert meta["n_shards"] == nproc, meta
    assert meta["corpus_rows"] == int((bucket_ids >= 0).sum()) + R, meta
    for name, ref in (
        ("buckets", buckets),
        ("bucket_ids", bucket_ids),
        ("tail", tail),
        ("tail_ids", tail_ids),
    ):
        arr = getattr(idx2, name)
        for sh in arr.addressable_shards:
            np.testing.assert_array_equal(
                np.asarray(sh.data), ref[sh.index], err_msg=name
            )
    np.testing.assert_array_equal(np.asarray(idx2.centroids), centroids)


def run_encode(pid: int, nproc: int, port: str, tmpdir: str) -> None:
    """The production multi-host corpus-encode recipe for real: process 0
    tokenizes the corpus to a shared store, both processes encode their
    rank-mod stride slice (the reference's StreamingDataset sharding,
    src/utils.py:133-147) on their LOCAL devices and write disjoint block
    ranges into one shared embedding store; process 0 then stitches and
    asserts equality with a single-pass encode."""
    jax = _init(pid, nproc, port)
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh

    from haconvdr_tpu.config import ModelConfig
    from haconvdr_tpu.index.build import encode_corpus
    from haconvdr_tpu.index.store import (
        EmbeddingBlockStore,
        TokenizedCorpus,
        TokenizedCorpusWriter,
    )
    from haconvdr_tpu.models.encoder import init_encoder_params
    from haconvdr_tpu.parallel.sharded_encode import (
        make_sharded_encode_fn,
        shard_params,
    )

    cfg = ModelConfig.tiny()
    params = init_encoder_params(jax.random.PRNGKey(2), cfg)
    # per-host local mesh: each process encodes on its own devices (the
    # corpus stream is host-sharded by stride/offset, not device-sharded)
    local = Mesh(np.array(jax.local_devices()), ("dp",))
    fn = make_sharded_encode_fn(local, cfg)
    sp = shard_params(local, params)

    L, n = 10, 53
    tok_dir = os.path.join(tmpdir, "tok")
    if pid == 0:
        rs = np.random.RandomState(7)
        w = TokenizedCorpusWriter(tok_dir, L)
        for i in range(n):
            w.add(
                1000 + i,
                rs.randint(
                    4, cfg.vocab_size, size=rs.randint(3, L + 1)
                ).tolist(),
            )
        w.finalize()
    multihost_utils.sync_global_devices("encode:tokenized")
    corpus = TokenizedCorpus(tok_dir)

    shared = os.path.join(tmpdir, "shared")
    # disjoint block-id ranges per process (each stride slice has
    # ceil(n/nproc) <= 27 rows -> 2 blocks of 16)
    encode_corpus(
        corpus, fn, sp, shared, batch_size=8, per_block_passage_num=16,
        stride=nproc, offset=pid, start_block_id=2 * pid,
    )
    multihost_utils.sync_global_devices("encode:blocks")

    if pid == 0:
        single = os.path.join(tmpdir, "single")
        encode_corpus(
            corpus, fn, sp, single, batch_size=8, per_block_passage_num=16
        )

        def id_map(store_dir):
            store = EmbeddingBlockStore(store_dir)
            out = {}
            for b in range(store.num_blocks()):
                emb, ids = store.read_block(b)
                for row, off in zip(np.asarray(emb), np.asarray(ids)):
                    assert int(off) not in out
                    out[int(off)] = row
            return out

        ref = id_map(single)
        got = id_map(shared)
        assert set(ref) == set(got) == set(range(n))
        for off in ref:
            np.testing.assert_array_equal(ref[off], got[off])
    multihost_utils.sync_global_devices("encode:checked")


if __name__ == "__main__":
    mode, pid, nproc, port, tmpdir = sys.argv[1:6]
    {"ivf": run_ivf, "encode": run_encode}[mode](
        int(pid), int(nproc), port, tmpdir
    )
    print(f"mp_worker {mode} pid={pid}: OK", flush=True)
