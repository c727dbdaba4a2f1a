"""The result plots (``rgbmanip_tpu_torch/scripts/plot_results.py``) against
the JAX package's ``scripts/plot_results.py``: from the same
``metrics.jsonl`` (``MetricsWriter``'s form, with a torn line) both write
the same files, draw the same series and print the same lines."""

import importlib.util
import json
import os
import sys

import matplotlib.axes
import pytest

from rgbmanip_tpu_torch.scripts import plot_results as port_plot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def log_dir(tmp_path):
    d = tmp_path / "logs"
    d.mkdir()
    recs = [("test/success_rate", 16, 62.5), ("test/success_rate", 8, 50.0),
            ("train/loss", 1, 0.9), ("train/loss", 2, 0.7), ("test/success_rate", 24, 70.8)]
    lines = [json.dumps({"tag": t, "step": s, "value": v, "time": 0.0}) for t, s, v in recs]
    (d / "metrics.jsonl").write_text("\n".join(lines[:3] + ['{"tag": "torn'] + lines[3:]) + "\n")
    return d


def run(main, log_dir, out, monkeypatch, capsys):
    drawn = []
    orig = matplotlib.axes.Axes.plot

    def plot(self, *args, **kwargs):
        drawn.append(tuple(tuple(a) for a in args[:2]))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(matplotlib.axes.Axes, "plot", plot)
    main(["--log_dir", str(log_dir), "--out", str(out), "--tags", "train/loss",
          "test/success_rate", "missing/tag"])
    monkeypatch.undo()
    printed = capsys.readouterr().out.replace(str(out), "OUT")
    return sorted(os.listdir(out)), drawn, printed


def test_the_same_files_series_and_lines_as_the_jax_script(log_dir, tmp_path, monkeypatch,
                                                          capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_plot_results", os.path.join(REPO, "scripts", "plot_results.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def jax_main(argv):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", ["plot_results.py"] + argv)
            mod.main()

    assert port_plot.load_metrics(str(log_dir / "metrics.jsonl")) == \
        mod.load_metrics(str(log_dir / "metrics.jsonl"))
    ref = run(jax_main, log_dir, tmp_path / "jax", monkeypatch, capsys)
    out = run(port_plot.main, log_dir, tmp_path / "port", monkeypatch, capsys)
    assert out == ref
    assert out[0] == ["test_success_rate.pdf", "train_loss.pdf"]
    assert out[1] == [((1, 2), (0.9, 0.7)), ((8, 16, 24), (50.0, 62.5, 70.8))]
    assert "skip missing/tag" in out[2]
