"""The port's checkpoints against the reference's (``repro.checkpoint``):
the port's plain-Python msgpack encoder writes ``msgpack.packb``'s bytes,
a file either package writes loads in the other, zlib and zstd, params in
the reference's layout survive both directions through ``convert.py``
bit for bit (bf16 included), and a trainer restored from a checkpoint runs
the next round bit for bit as the uninterrupted one.  Everything here is
exact: no tolerance.
"""
import collections
import dataclasses
import json

import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.checkpoint import msgpack_ckpt as jckpt                # noqa: E402

from repro_torch.checkpoint import msgpack_ckpt as ckpt           # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax    # noqa: E402
from repro_torch.core import (AstraeaTrainer, FedAvgTrainer, LocalSpec,  # noqa: E402
                              load_trainer, save_trainer)
from repro_torch.data.federated import EMNIST_LIKE, partition      # noqa: E402
from repro_torch.models.cnn import emnist_cnn, init_params         # noqa: E402
from repro_torch.optim import adam                                 # noqa: E402

from torch_parity import reference_params                         # noqa: E402

Pair = collections.namedtuple("Pair", "first second")


def _tree(rng):
    """A nested tree of every tag and msgpack form the format uses."""
    return {
        "array": rng.standard_normal((3, 5)).astype(np.float32),
        "ints": np.arange(7, dtype=np.int32),
        "empty": np.zeros((0, 4), np.float64),
        "scalars": [np.float32(1.5), np.int64(-7), np.float64(2.0 ** 60)],
        "tuple": (1, -1, -33, 200, -200, 70_000, -70_000, 2 ** 33, -(2 ** 33),
                  2 ** 63, 0.1, True, False, None),
        "named": Pair(np.ones(2, np.int8), [1, "x" * 40]),
        "strings": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70_000],
        "wide": {str(i): i for i in range(20)},
        "long": list(range(20)),
        "bytes": b"z" * 300,
    }


@pytest.mark.parametrize("seed", range(3))
def test_encoder_bytes_equal_msgpack(seed):
    rng = np.random.default_rng(seed)
    enc = ckpt._encode(_tree(rng))
    assert ckpt.packb(enc) == msgpack.packb(enc, use_bin_type=True)
    assert ckpt.unpackb(ckpt.packb(enc)) == msgpack.unpackb(
        msgpack.packb(enc, use_bin_type=True), raw=False)


def _same(port, want) -> bool:
    """A port-decoded tree equals the tree that was written, bit for bit
    (a NamedTuple reads back as a dict of its fields, as in the reference;
    arrays as CPU tensors of the same dtype and bytes)."""
    if isinstance(want, tuple) and hasattr(want, "_fields"):
        want = want._asdict()
    if isinstance(want, dict):
        return isinstance(port, dict) and list(port) == list(want) and \
            all(_same(port[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return type(port) is type(want) and len(port) == len(want) and \
            all(_same(a, b) for a, b in zip(port, want))
    if isinstance(want, np.ndarray):
        if want.dtype.name in LOW:
            raw = {1: np.uint8, 2: np.int16}[want.dtype.itemsize]
            return port.dtype == LOW[want.dtype.name] and \
                port.view(TORCH_RAW[raw]).numpy().tobytes() == want.view(raw).tobytes()
        got = port.numpy()
        return got.dtype == want.dtype and got.shape == want.shape and \
            got.tobytes() == want.tobytes()
    return type(port) is type(want) and port == want


LOW = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
       "float8_e5m2": torch.float8_e5m2}
TORCH_RAW = {np.uint8: torch.uint8, np.int16: torch.int16}


def _low_precision(rng):
    return {"bf16": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16),
            "e4m3": rng.standard_normal(6).astype(ml_dtypes.float8_e4m3fn),
            "e5m2": rng.standard_normal(6).astype(ml_dtypes.float8_e5m2)}


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name in LOW:
        raw = {1: np.uint8, 2: np.int16}[a.dtype.itemsize]
        return torch.from_numpy(a.view(raw).copy()).view(LOW[a.dtype.name])
    return torch.from_numpy(a.copy())


def _packed(path) -> bytes:
    return ckpt._decompress(open(path, "rb").read())


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_reference_file_loads_in_port(tmp_path, monkeypatch, codec):
    """Every tag, bf16 and fp8 written by the reference: the port reads
    back the tree that was written."""
    if codec == "zlib":
        monkeypatch.setattr(jckpt, "zstandard", None)
    rng = np.random.default_rng(1)
    tree = {**_tree(rng), **_low_precision(rng)}
    path = str(tmp_path / "ref.ckpt")
    jckpt.save_pytree(path, tree, {"round": 3})
    magic = open(path, "rb").read(4) == b"\x28\xb5\x2f\xfd"
    assert magic == (codec == "zstd")
    assert _same(ckpt.load_pytree(path), tree)


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_port_file_loads_in_reference(tmp_path, monkeypatch, codec):
    """The same tree written by the port (its arrays as tensors, bf16 and
    fp8 included) and by the reference: the same compressed bytes, and the
    reference reads the port's file."""
    if codec == "zlib":
        monkeypatch.setattr(ckpt, "zstandard", None)
        monkeypatch.setattr(jckpt, "zstandard", None)
    rng = np.random.default_rng(2)
    tree = {**_tree(rng), **_low_precision(rng)}
    as_port = {k: _as_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in tree.items()}
    ref_path, port_path = str(tmp_path / "ref.ckpt"), str(tmp_path / "port.ckpt")
    jckpt.save_pytree(ref_path, tree)
    ckpt.save_pytree(port_path, as_port, {"round": 3})
    assert json.load(open(port_path + ".meta.json")) == {"round": 3}
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()
    assert _packed(port_path) == msgpack.packb(jckpt._encode(tree), use_bin_type=True)
    ref = jckpt.load_pytree(port_path)
    np.testing.assert_array_equal(np.asarray(ref["array"]), tree["array"])
    assert np.asarray(ref["bf16"]).tobytes() == tree["bf16"].tobytes()
    assert ref["tuple"] == tree["tuple"] and ref["strings"] == tree["strings"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_layout_params_round_trip(tmp_path, dtype):
    """Reference-layout CNN params (bf16 too) written by the reference, read
    by the port into a state dict (``params_from_jax``), written back in
    the reference's layout (``params_to_jax``) and read by the reference:
    every leaf bit for bit."""
    tree = reference_params(8, 16, 0)
    tree = {l: {k: np.asarray(v).astype(getattr(ml_dtypes, dtype, np.float32))
                for k, v in leaves.items()} for l, leaves in tree.items()}
    ref_path, port_path = str(tmp_path / "ref.ckpt"), str(tmp_path / "port.ckpt")
    jckpt.save_pytree(ref_path, tree)
    state = params_from_jax(ckpt.load_pytree(ref_path))
    assert all(v.dtype == getattr(torch, dtype) for v in state.values())
    assert state["conv1.weight"].shape == tuple(
        np.asarray(tree["conv1"]["w"]).transpose(3, 2, 0, 1).shape)
    ckpt.save_pytree(port_path, params_to_jax(state))
    back = jckpt.load_pytree(port_path)
    for l in tree:
        for k in tree[l]:
            want, got = np.asarray(tree[l][k]), np.asarray(back[l][k])
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (l, k)


def test_zstd_frame_without_zstandard_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "z.ckpt")
    jckpt.save_pytree(path, {"a": np.ones(3, np.float32)})
    assert open(path, "rb").read(4) == b"\x28\xb5\x2f\xfd"
    monkeypatch.setattr(ckpt, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        ckpt.load_pytree(path)


def _federation():
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16)
    return partition(spec, num_clients=12, total_samples=300, test_samples=80,
                     sizes="instagram", global_dist="letterfreq", local="random",
                     seed=0)


def _trainer(kind, fed, row_exec="vmap", **lora):
    common = dict(clients_per_round=8, local=LocalSpec(10, 1), seed=0, device="cpu",
                  init_params=init_params(emnist_cnn(8, 16), 0), row_exec=row_exec,
                  **lora)
    if kind == "fedavg":
        return FedAvgTrainer(emnist_cnn(8, 16), adam(1e-3), fed, **common)
    return AstraeaTrainer(emnist_cnn(8, 16), adam(1e-3), fed, gamma=4, alpha=0.67,
                          **common)


@pytest.mark.parametrize("kind", ["astraea", "fedavg"])
def test_trainer_round_trip(tmp_path, kind):
    """Two rounds, saved; a fresh trainer loads the file: params bit for
    bit, round and WAN bytes; the reference reads the same params.  For
    Astraea (its schedule drawn once, its draws addressed by round) round
    3 of the restored trainer equals the uninterrupted one's bit for bit."""
    fed = _federation()
    tr = _trainer(kind, fed)
    tr.fit(2, eval_every=2)
    path = str(tmp_path / "trainer.ckpt")
    save_trainer(path, tr, extra={"kind": kind})
    meta = json.load(open(path + ".meta.json"))
    assert meta["round"] == 2 and meta["kind"] == kind
    ref = jckpt.load_pytree(path)
    want = params_to_jax(tr.params)
    assert int(ref["round"]) == 2 and float(ref["traffic_bytes"]) == tr.comm.total_bytes
    for l in want:
        for k in want[l]:
            assert np.asarray(ref["params"][l][k]).tobytes() == want[l][k].tobytes()
    fresh = load_trainer(path, _trainer(kind, fed))
    assert fresh._round == 2 and fresh.comm.total_bytes == tr.comm.total_bytes
    assert all(torch.equal(fresh.params[k], tr.params[k]) for k in tr.params)
    if kind == "astraea":
        tr.run_round()
        fresh.run_round()
        assert all(torch.equal(fresh.params[k], tr.params[k]) for k in tr.params)
        assert fresh.comm.total_bytes == tr.comm.total_bytes


@pytest.mark.parametrize("kind", ["astraea", "fedavg"])
def test_lora_trainer_round_trip(tmp_path, kind):
    """Under LoRA the params are the frozen backbone: the file also holds
    the adapter state and the A bases, and a fresh trainer (its A zeroed
    first) gets both back bit for bit, so its merged weights and, for
    Astraea, its next round equal the uninterrupted trainer's.  The
    reference reads the file's params.  A LoRA file in a full-delta
    trainer, and a full-delta file in a LoRA trainer, raise."""
    fed = _federation()
    tr = _trainer(kind, fed, lora_rank=2)
    tr.fit(2, eval_every=2)
    eng = tr.engine
    assert any(bool(v.abs().sum()) for k, v in eng.adapters.items()
               if k.endswith("dense1/w"))    # the rounds moved the state
    path = str(tmp_path / "lora.ckpt")
    save_trainer(path, tr)
    ref = jckpt.load_pytree(path)
    want = params_to_jax(tr.params)
    assert all(np.asarray(ref["params"][l][k]).tobytes() == want[l][k].tobytes()
               for l in want for k in want[l])
    fresh = _trainer(kind, fed, lora_rank=2)
    fresh.engine.load_lora_a({k: torch.zeros_like(v)
                              for k, v in fresh.engine.lora_args()[1].items()})
    load_trainer(path, fresh)
    assert fresh._round == 2 and fresh.comm.total_bytes == tr.comm.total_bytes
    for got, exp in ((fresh.engine.adapters, eng.adapters),
                     (fresh.engine.lora_args()[1], eng.lora_args()[1]),
                     (fresh.params, tr.params),
                     (fresh.engine.merged_params(), eng.merged_params())):
        assert set(got) == set(exp) and all(torch.equal(got[k], exp[k]) for k in exp)
    if kind == "astraea":
        tr.run_round()
        fresh.run_round()
        assert all(torch.equal(fresh.engine.adapters[k], eng.adapters[k])
                   for k in eng.adapters)
    with pytest.raises(ValueError, match="disagree on LoRA"):
        load_trainer(path, _trainer(kind, fed))
    full = str(tmp_path / "full.ckpt")
    save_trainer(full, _trainer(kind, fed))
    with pytest.raises(ValueError, match="disagree on LoRA"):
        load_trainer(full, _trainer(kind, fed, lora_rank=2))


def test_reference_trainer_file_loads_in_port(tmp_path):
    """The reference's ``save_trainer`` (its trainers cannot run under the
    installed JAX, so a stand-in holding reference-layout params, a round
    and a meter) loads into a port trainer bit for bit."""
    from repro.core.comm import CommMeter as JCommMeter
    params = reference_params(8, 16, 3)
    stand_in = type("T", (), {})()
    stand_in.params = {l: {k: jnp.asarray(v) for k, v in leaves.items()}
                       for l, leaves in params.items()}
    stand_in._round, stand_in.comm = 5, JCommMeter(1000)
    stand_in.comm.total_bytes = 123456.0
    path = str(tmp_path / "ref_trainer.ckpt")
    jckpt.save_trainer(path, stand_in)
    tr = load_trainer(path, _trainer("astraea", _federation()))
    assert tr._round == 5 and tr.comm.total_bytes == 123456.0
    want = params_from_jax(params)
    assert all(torch.equal(tr.params[k], want[k]) for k in want)
