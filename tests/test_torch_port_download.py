"""The port's dev-dataset downloaders (``pd_fusion_torch/data/download``) and
``download-dev``, offline: every case of ``tests/test_download.py`` against
the port's modules (a file or accession that exists is skipped, a failed
transfer leaves no partial file, no ``openneuro`` CLI means nothing is
fetched, ``metadata_only`` builds the ``--include`` filters, the manual
instructions name the restricted sources), and the CLI against the JAX
package's on the same directory. The fetches are stubbed: neither machine
has a network."""
import subprocess
import sys
import urllib.request

import pytest

from pd_fusion.data.download import download_manager as jax_manager
from pd_fusion_torch import cli
from pd_fusion_torch.data.download import download_manager, openneuro_download, uci_download


def _no_network(*a, **k):  # pragma: no cover - must never run
    raise AssertionError("network touched")


def test_uci_fetch_skips_existing_without_network(tmp_path, monkeypatch):
    dest = tmp_path / "uci" / "parkinsons.data"
    dest.parent.mkdir(parents=True)
    dest.write_text("cached")
    monkeypatch.setattr(urllib.request, "urlopen", _no_network)
    uci_download.fetch("http://example.invalid/x", dest)
    assert dest.read_text() == "cached"


def test_uci_fetch_failure_leaves_no_partial_file(tmp_path, monkeypatch):
    dest = tmp_path / "uci" / "parkinsons.data"

    class _Resp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self, n):
            raise OSError("connection reset mid-stream")

    monkeypatch.setattr(urllib.request, "urlopen", lambda *a, **k: _Resp())
    with pytest.raises(OSError):
        uci_download.fetch("http://example.invalid/x", dest)
    assert not dest.exists()


def test_uci_fetch_streams_the_body_into_place(tmp_path, monkeypatch):
    dest = tmp_path / "uci" / "parkinsons.data"
    body = [b"name,MDVP:Fo(Hz)\n", b"phon_R01_S01_1,119.992\n", b""]

    class _Resp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self, n):
            return body.pop(0)

    monkeypatch.setattr(urllib.request, "urlopen", lambda *a, **k: _Resp())
    uci_download.fetch("http://example.invalid/x", dest)
    assert dest.read_bytes() == b"name,MDVP:Fo(Hz)\nphon_R01_S01_1,119.992\n"


def test_openneuro_skips_when_cli_missing(tmp_path, monkeypatch):
    import shutil as _shutil

    monkeypatch.setattr(_shutil, "which", lambda name: None)
    openneuro_download.download_openneuro_datasets(tmp_path)
    assert not (tmp_path / "openneuro").exists()


def test_openneuro_fetch_accession_skips_existing(tmp_path, monkeypatch):
    import subprocess as _subprocess

    (tmp_path / "ds001907").mkdir(parents=True)
    monkeypatch.setattr(_subprocess, "run", _no_network)
    openneuro_download.fetch_accession("ds001907", tmp_path)


def test_openneuro_metadata_only_builds_include_filters(tmp_path, monkeypatch):
    import subprocess as _subprocess

    seen = {}

    def _capture(cmd, check):
        seen["cmd"] = cmd

    monkeypatch.setattr(_subprocess, "run", _capture)
    openneuro_download.fetch_accession("ds004471", tmp_path, metadata_only=True)
    cmd = seen["cmd"]
    assert cmd[:3] == ["openneuro", "download", "ds004471"]
    for name in openneuro_download.METADATA_FILES:
        assert name in cmd
    assert openneuro_download.ACCESSIONS == ("ds004471", "ds004392", "ds001907")


def test_manual_instructions_match_the_jax_package(capsys):
    download_manager.print_manual_instructions()
    out = capsys.readouterr().out
    assert "Synapse" in out and "BioFIND" in out
    assert "data/raw_dev/synapse/" in out
    jax_manager.print_manual_instructions()
    assert capsys.readouterr().out == out


def test_download_dev_through_both_clis_on_existing_files(tmp_path, monkeypatch, capsys):
    """``download-dev --dataset all`` where the UCI files exist and no
    ``openneuro`` CLI is installed: both CLIs fetch nothing, print the same
    instructions and leave the same directory."""
    import shutil as _shutil

    from pd_fusion import cli as jax_cli

    monkeypatch.setattr(urllib.request, "urlopen", _no_network)
    monkeypatch.setattr(_shutil, "which", lambda name: None)
    outs = []
    for which, run in (("port", lambda out: cli.main(["download-dev", "--out", str(out)])),
                       ("jax", lambda out: jax_cli.main())):
        out = tmp_path / which
        (out / "uci").mkdir(parents=True)
        for name in uci_download.UCI_SOURCES:
            (out / "uci" / name).write_text("cached")
        monkeypatch.setattr(sys, "argv", ["pd_fusion", "download-dev", "--out", str(out)])
        run(out)
        outs.append((capsys.readouterr().out,
                     sorted(p.relative_to(out).as_posix() for p in out.rglob("*"))))
    assert outs[0] == outs[1]
    assert "MANUAL DOWNLOAD REQUIRED" in outs[0][0]


def test_download_dev_runs_as_a_module(tmp_path):
    """``python -m pd_fusion_torch.cli download-dev --dataset manual`` exits 0
    and prints the instructions (no subcommand of the port is refused)."""
    run = subprocess.run([sys.executable, "-m", "pd_fusion_torch.cli", "download-dev",
                          "--dataset", "manual", "--out", str(tmp_path / "dev")],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(cli.__file__).rsplit("/pd_fusion_torch", 1)[0],
                              "PATH": "/usr/bin:/bin"})
    assert run.returncode == 0, run.stderr
    assert "BioFIND (LONI/IDA)" in run.stdout
