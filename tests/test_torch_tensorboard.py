"""The TensorBoard mirror of the port's ``MetricsWriter``
(``rgbmanip_tpu_torch/utils/logger.py``) against the JAX package's writer,
which mirrors through ``torch.utils.tensorboard.SummaryWriter``.

- The same scalars written by both: the events read back from each file
  have equal tags, steps and values (simple values, f32), in the same
  order, after the same version event. Wall times differ.
- The port's file frames as valid TFRecords: each record's length and
  payload checksums (masked CRC32C) verified with TensorBoard's own
  checksum (``tensorboard.compat.tensorflow_stub``), and nothing after the
  last record.
- The port writes its file without loading TensorFlow or JAX (TensorBoard's
  writers load TensorFlow where it is installed, and TensorFlow loads JAX
  here): after a write, none of ``jax``, ``flax``, ``tensorflow`` or
  ``rgbmanip_tpu`` is in ``sys.modules`` of a process that imports only the
  port.
"""

import glob
import json
import os
import struct
import subprocess
import sys

import pytest

SCALARS = [("ppo/loss", 0.125, 0), ("ppo/kl", 3.5e-3, 0), ("test/success_rate", 87.5, 8),
           ("ppo/loss", -2.0, 1), ("train/lr", 1e-4, 7), ("x", 1e30, 2 ** 40)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def records(path):
    """The TFRecords of ``path``: each payload, its framing checked."""
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import masked_crc32c

    data = open(path, "rb").read()
    out, i = [], 0
    while i < len(data):
        assert len(data) - i >= 16, "a truncated record"
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        (crc_head,) = struct.unpack("<I", data[i + 8:i + 12])
        assert crc_head == masked_crc32c(head), f"length checksum at byte {i}"
        payload = data[i + 12:i + 12 + n]
        (crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        assert len(payload) == n and crc == masked_crc32c(payload), f"payload at byte {i}"
        out.append(payload)
        i += 16 + n
    assert i == len(data)
    return out


def events(log_dir):
    from tensorboard.compat.proto import event_pb2

    (path,) = glob.glob(os.path.join(str(log_dir), "events.out.tfevents.*"))
    return [event_pb2.Event.FromString(p) for p in records(path)]


def write_all(writer):
    for tag, value, step in SCALARS:
        writer.add_scalar(tag, value, step)
    writer.close()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from rgbmanip_tpu.utils.logger import MetricsWriter as JaxWriter
    from rgbmanip_tpu_torch.utils.logger import MetricsWriter

    jdir, pdir = tmp_path_factory.mktemp("jax_tb"), tmp_path_factory.mktemp("port_tb")
    write_all(JaxWriter(str(jdir)))
    write_all(MetricsWriter(str(pdir)))
    return jdir, pdir


def test_tags_steps_and_values_equal_the_jax_writers(both):
    jdir, pdir = both
    jev, pev = events(jdir), events(pdir)
    assert jev[0].file_version == pev[0].file_version == "brain.Event:2"
    assert jev[0].source_metadata.writer == pev[0].source_metadata.writer

    def scalars(evs):
        return [(v.tag, v.simple_value, e.step) for e in evs[1:] for v in e.summary.value]
    assert scalars(pev) == scalars(jev)
    assert len(scalars(pev)) == len(SCALARS) == len(pev) - 1
    for e in pev:
        assert e.wall_time > 0
    # the JSONL beside it, as before
    lines = [json.loads(x) for x in open(pdir / "metrics.jsonl")]
    assert [(d["tag"], d["value"], d["step"]) for d in lines] == [
        (t, float(v), s) for t, v, s in SCALARS]


def test_the_event_file_frames_as_tfrecords(both):
    _, pdir = both
    (path,) = glob.glob(os.path.join(str(pdir), "events.out.tfevents.*"))
    assert len(records(path)) == len(SCALARS) + 1
    from rgbmanip_tpu_torch.utils.logger import masked_crc32c, tfrecord
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import masked_crc32c as ref

    for payload in (b"", b"a", bytes(range(256)) * 3):
        assert masked_crc32c(payload) == ref(payload)
        rec = tfrecord(payload)
        assert len(rec) == len(payload) + 16 and rec[12:12 + len(payload)] == payload


def test_a_write_loads_no_tensorflow_or_jax(tmp_path):
    code = (
        "import json, sys\n"
        "from rgbmanip_tpu_torch.utils.logger import MetricsWriter\n"
        f"w = MetricsWriter({str(tmp_path)!r})\n"
        "w.add_scalar('a', 1.0, 0)\n"
        "w.close()\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                    "tensorflow", "rgbmanip_tpu")]
    assert not bad, bad
    assert "tensorboard.compat.proto.event_pb2" in loaded
    assert len(events(tmp_path)) == 2


def test_without_tensorboard_the_writer_keeps_the_jsonl_alone(tmp_path, monkeypatch):
    """Where TensorBoard is not installed (the card's machine), no event
    file is written, as the JAX package's writer falls back."""
    import builtins

    from rgbmanip_tpu_torch.utils.logger import MetricsWriter

    real = builtins.__import__

    def no_tensorboard(name, *a, **kw):
        if name.startswith("tensorboard"):
            raise ImportError(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    w = MetricsWriter(str(tmp_path))
    w.add_scalar("a", 1.0, 0)
    w.close()
    assert os.listdir(tmp_path) == ["metrics.jsonl"]
