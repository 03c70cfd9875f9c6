"""The port's copy of the streaming ingest tier (``repro_torch.io`` and
``fe.datagen.write_log_shards``) against the JAX package's ``repro.io``, on
the CPU: the same seed writes the same bytes, each package reads the
other's shards, and the ordered loader yields the same batches."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fe.colstore import RaggedColumn as JaxRaggedColumn  # noqa: E402
from repro.fe.datagen import write_log_shards as jax_write_log_shards  # noqa: E402
from repro.io import chaos as jax_chaos  # noqa: E402
from repro.io.dataset import ShardDataset as JaxShardDataset  # noqa: E402
from repro.io.shardfmt import ShardReader as JaxShardReader  # noqa: E402
from repro.io.stream import StreamingLoader as JaxStreamingLoader  # noqa: E402

from repro_torch.fe import featureplan, get_spec  # noqa: E402
from repro_torch.fe.colstore import RaggedColumn  # noqa: E402
from repro_torch.fe.datagen import write_log_shards  # noqa: E402
from repro_torch.io import chaos  # noqa: E402
from repro_torch.io.dataset import ShardDataset  # noqa: E402
from repro_torch.io.shardfmt import ShardFormatError, ShardReader  # noqa: E402
from repro_torch.io.stream import StreamingLoader  # noqa: E402

N_SHARDS, ROWS = 4, 48


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    port = str(tmp_path_factory.mktemp("port"))
    ref = str(tmp_path_factory.mktemp("jax"))
    write_log_shards(port, n_shards=N_SHARDS, rows_per_shard=ROWS, seed=3)
    jax_write_log_shards(ref, n_shards=N_SHARDS, rows_per_shard=ROWS, seed=3)
    return port, ref


def _assert_columns_equal(got, want, where):
    assert sorted(got) == sorted(want), where
    for name in want:
        g, w = got[name], want[name]
        if isinstance(w, (RaggedColumn, JaxRaggedColumn)):
            np.testing.assert_array_equal(g.values, w.values, err_msg=f"{where}.{name}")
            np.testing.assert_array_equal(g.lengths, w.lengths, err_msg=f"{where}.{name}")
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"{where}.{name}")


def test_write_log_shards_bytes_match_jax(shard_dirs):
    port, ref = shard_dirs
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(port))
    assert len([n for n in names if n.endswith(".fbshard")]) == N_SHARDS
    assert "manifest.json" in names
    for name in names:
        assert filecmp.cmp(os.path.join(port, name), os.path.join(ref, name),
                           shallow=False), name


@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
def test_readers_read_each_others_shards(shard_dirs, direction):
    port, ref = shard_dirs
    src, own = (ref, port) if direction == "port_reads_jax" else (port, ref)
    reader_cls, own_cls = ((ShardReader, JaxShardReader) if direction == "port_reads_jax"
                           else (JaxShardReader, ShardReader))
    for name in sorted(n for n in os.listdir(src) if n.endswith(".fbshard")):
        got = reader_cls(os.path.join(src, name)).read_all()
        want = own_cls(os.path.join(own, name)).read_all()
        assert sorted(got) == sorted(want)
        for table in want:
            _assert_columns_equal(got[table], want[table], f"{name}:{table}")
        if direction == "port_reads_jax":
            ragged = [c for t in got.values() for c in t.values()
                      if hasattr(c, "lengths")]
            assert ragged and all(isinstance(c, RaggedColumn) for c in ragged)


def test_ordered_loader_yields_the_same_batches_as_jax(shard_dirs):
    port, ref = shard_dirs
    columns = featureplan.compile(get_spec("dlrm")).required_columns
    ds, jds = ShardDataset(port), JaxShardDataset(ref)
    assert [s.n_rows for s in ds.shards] == [s.n_rows for s in jds.shards]
    kw = dict(workers=3, prefetch=2, epochs=2, shuffle=True, seed=0, ordered=True)
    loader = StreamingLoader(ds, columns=columns, **kw)
    jloader = JaxStreamingLoader(jds, columns=columns, **kw)
    assert loader.rows_hint == jloader.rows_hint == ROWS
    got, want = list(loader), list(jloader)
    assert len(got) == len(want) == 2 * N_SHARDS
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for table in w:
            _assert_columns_equal(g[table], w[table], f"batch {i}:{table}")
    for field in ("shards", "bytes_read", "bytes_decoded", "columns_decoded"):
        assert getattr(loader.stats, field) == getattr(jloader.stats, field), field
    loader.close()
    jloader.close()


def test_chaos_kill_keeps_the_ordered_stream_like_jax(shard_dirs):
    """A reader killed mid-shard: the ordered stream is unchanged, as in the
    JAX package's chaos tests."""
    port, _ = shard_dirs
    clean = list(StreamingLoader(ShardDataset(port), workers=2, ordered=True))
    events = chaos.parse_chaos_spec("kill@1:read,transient@2:read:1")
    assert [dataclasses.astuple(e) for e in events] == \
        [dataclasses.astuple(e) for e in jax_chaos.parse_chaos_spec(
            "kill@1:read,transient@2:read:1")]
    injector = chaos.ChaosInjector(events)
    loader = StreamingLoader(ShardDataset(port), workers=2, ordered=True,
                             lease_timeout=0.2, chaos=injector)
    hurt = list(loader)
    assert injector.exhausted()
    assert loader.fault_stats.retries == 1 and loader.fault_stats.reissued >= 1
    assert len(hurt) == len(clean)
    for i, (g, w) in enumerate(zip(hurt, clean)):
        for table in w:
            _assert_columns_equal(g[table], w[table], f"batch {i}:{table}")


def test_corrupt_shard_fails_the_reader(tmp_path):
    write_log_shards(str(tmp_path), n_shards=1, rows_per_shard=8, seed=0)
    path = tmp_path / "shard_00000.fbshard"
    data = bytearray(path.read_bytes())
    data[-5] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(ShardFormatError):
        ShardReader(str(path)).read_all()
