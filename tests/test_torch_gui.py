"""The port's GUI front-ends (copies of the JAX package's): the shared
argv builder and StreamDrainer headlessly, the form models against the
JAX package's, and the Qt/Tk widget smoke tests where a toolkit and a
display exist (skipped headless, as tests/test_gui.py skips them)."""

import pytest

from barcoder_tpu_torch.cli.gui import TOOLS, build_argv
from barcoder_tpu_torch.cli.gui_qt import _is_pathlike


def _qt_available() -> bool:
    try:
        import os

        os.environ.setdefault("QT_QPA_PLATFORM", "offscreen")
        from PyQt5.QtWidgets import QApplication  # noqa: F401

        return True
    except Exception:
        return False


def _tk_available() -> bool:
    try:
        import tkinter

        tkinter.Tk().destroy()
        return True
    except Exception:
        return False


class TestFormModel:
    def test_every_tool_builds_argv(self):
        for tool, spec in TOOLS.items():
            answers = {
                name: (default or ("a b" if name == "files" else "X"))
                for name, _, default in spec
            }
            argv = build_argv(tool, answers)
            assert argv[0] == tool
            # flags carry their values; positionals appear in spec order
            for name, _, _ in spec:
                if name.startswith("--"):
                    assert name in argv
                    assert argv[argv.index(name) + 1] == str(answers[name])

    def test_empty_optional_fields_are_omitted(self):
        argv = build_argv("count", {"fasta_file": "b.fa", "file1": "r.fq", "file2": ""})
        assert argv == ["count", "b.fa", "r.fq"]

    def test_files_field_splits(self):
        argv = build_argv("distill", {"files": "a.fastq b.fastq"})
        assert argv == ["distill", "a.fastq", "b.fastq"]

    def test_forms_equal_the_jax_package(self):
        from barcoder_tpu.cli import gui as jax_gui

        assert TOOLS == jax_gui.TOOLS
        for tool, spec in TOOLS.items():
            answers = {name: default or "v" for name, _, default in spec}
            assert build_argv(tool, answers) == jax_gui.build_argv(tool, answers)

    def test_pathlike_detection(self):
        assert _is_pathlike("genome_file")
        assert _is_pathlike("fasta_file")
        assert _is_pathlike("files")
        assert not _is_pathlike("pam")
        assert not _is_pathlike("mismatches")


def test_gui_help_names_the_port():
    """``python -m barcoder_tpu_torch gui --help`` answers without a prompt."""
    import subprocess
    import sys

    from pathlib import Path

    proc = subprocess.run([sys.executable, "-m", "barcoder_tpu_torch", "gui", "--help"],
                          capture_output=True, text=True, timeout=120, stdin=subprocess.DEVNULL,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--graphical" in proc.stdout and "python -m barcoder_tpu_torch" in proc.stdout


class TestStreamDrainer:
    """Incremental subprocess-output drain shared by both graphical
    front-ends (ADVICE r2: no paragraph break per chunk, no U+FFFD from a
    UTF-8 sequence split across drains, portable off POSIX)."""

    def _spawn(self, code: str):
        import subprocess
        import sys

        return subprocess.Popen(
            [sys.executable, "-u", "-c", code],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )

    def _drain_all(self, proc, drainer, timeout=10.0):
        import time

        out = []
        t0 = time.time()
        while proc.poll() is None and time.time() - t0 < timeout:
            out.append(drainer.read())
            time.sleep(0.02)
        out.append(drainer.close())
        return "".join(out)

    def test_split_utf8_never_emits_replacement_char(self):
        from barcoder_tpu_torch.cli.gui import StreamDrainer

        # two-byte UTF-8 (é) written byte-by-byte with flushes + sleeps so
        # reads land mid-sequence
        code = (
            "import sys, time\n"
            "b = 'héllo wörld'.encode()\n"
            "for i in range(len(b)):\n"
            "    sys.stdout.buffer.write(b[i:i+1]); sys.stdout.flush()\n"
            "    time.sleep(0.01)\n"
        )
        proc = self._spawn(code)
        text = self._drain_all(proc, StreamDrainer(proc.stdout))
        assert "�" not in text
        assert "héllo wörld" in text

    def test_no_inserted_breaks_and_large_output_drains(self):
        from barcoder_tpu_torch.cli.gui import StreamDrainer

        # >64 KB on one line: would deadlock a blocking read-after-exit and
        # would be garbled by per-chunk appendPlainText
        code = "import sys\nsys.stdout.write('x' * 200000 + '\\nEND\\n')\n"
        proc = self._spawn(code)
        text = self._drain_all(proc, StreamDrainer(proc.stdout))
        assert text.count("\n") == 2
        assert text.startswith("x" * 1000)
        assert "END" in text

    def test_threaded_fallback_platforms_without_set_blocking(self, monkeypatch):
        import os

        from barcoder_tpu_torch.cli import gui

        def no_set_blocking(fd, blocking):
            raise OSError("not supported on this platform")

        monkeypatch.setattr(os, "set_blocking", no_set_blocking)
        proc = self._spawn("print('from the thread')")
        drainer = gui.StreamDrainer(proc.stdout)
        assert drainer._thread is not None  # reader-thread mode engaged
        text = self._drain_all(proc, drainer)
        assert "from the thread" in text


@pytest.mark.skipif(not _qt_available(), reason="PyQt5/display unavailable")
class TestQtSmoke:
    def test_form_to_argv(self):
        from barcoder_tpu_torch.cli.gui_qt import build_app

        app, window = build_app(["test"])
        form = window.forms["targets"]
        form.fields["sgrna_file"].setText("lib.tsv")
        form.fields["genome_file"].setText("g.gb")
        form.fields["mismatches"].setText("2")
        assert form.argv() == [
            "targets", "lib.tsv", "g.gb", "NGG", "2",
            "--pam_direction", "downstream",
        ]
        assert window.stack.count() == 1 + len(TOOLS)


@pytest.mark.skipif(not _tk_available(), reason="tkinter/display unavailable")
class TestTkSmoke:
    def test_form_to_argv(self):
        from barcoder_tpu_torch.cli.gui_tk import build_app

        root, app = build_app()
        try:
            app["show"]("targets")
            e = app["fields"]["targets"]
            e["sgrna_file"].insert(0, "lib.tsv")
            e["genome_file"].insert(0, "g.gb")
            assert app["argv_for"]("targets") == [
                "targets", "lib.tsv", "g.gb", "NGG", "1",
                "--pam_direction", "downstream",
            ]
        finally:
            root.destroy()
