"""Interactive shell — the reference's GUI role (extensible_GUI.py:19-204 +
targets_gui.py:24-301: a PyQt5 stacked-widget launcher whose form builds
argv for targets.py and runs it as a subprocess).

Here the same capability is a terminal UI (rich prompts — always available
on the environments this framework targets) that builds argv for any of the
five subcommands and runs it in-process; a PyQt5 front-end is gated on the
optional dependency and delegates to the same argv builder.
"""

from __future__ import annotations

import sys

from rich.console import Console
from rich.prompt import Confirm, Prompt
from rich.table import Table

TOOLS = {
    "targets": [
        ("sgrna_file", "Path to sgRNA FASTA/TSV file", None),
        ("genome_file", "Path to genome file", None),
        ("pam", "PAM sequence", "NGG"),
        ("mismatches", "Allowed mismatches", "1"),
        ("--pam_direction", "PAM direction (downstream/upstream)", "downstream"),
    ],
    "design": [
        ("genome_file", "Path to genome file", None),
        ("pam", "PAM sequence", "NGG"),
        ("barcode_length", "Guide length", "20"),
        ("--mismatches", "Off-target mismatches", "1"),
        ("--keep-top", "Guides per gene", "10"),
    ],
    "count": [
        ("fasta_file", "Barcode FASTA", None),
        ("file1", "Reads file 1 (FASTQ/.reads)", None),
        ("file2", "Reads file 2 (optional)", ""),
    ],
    "mismatch": [
        ("mode", "Mode (mismatches/recalculate)", "mismatches"),
        ("--spacers_file", "Spacers TSV (mismatches mode)", ""),
        ("--existing_mismatches", "Existing TSV (recalculate mode)", ""),
        ("--parameters_file", "Parameters CSV", ""),
    ],
    "distill": [
        ("files", "FASTQ file(s), space separated", None),
    ],
}

# one-line tool blurbs, shared by the TUI table and both graphical
# launchers (a single source so the three surfaces cannot drift)
TOOL_DESCRIPTIONS = {
    "targets": "Map a guide/barcode library to a genome",
    "design": "Design a genome-wide guide library",
    "count": "Count barcodes in sequencing reads",
    "mismatch": "Mismatch-efficacy model",
    "distill": "Sort + compress FASTQ reads",
}


class StreamDrainer:
    """Incremental subprocess-stdout drain shared by both graphical
    front-ends. Non-blocking pipe reads where the platform supports them
    (POSIX; Windows anonymous pipes only gained ``os.set_blocking`` in
    3.12), else a daemon reader thread feeding a queue — so Run never
    deadlocks on a full pipe and never blocks the event loop. Bytes pass
    through an incremental UTF-8 decoder: a multibyte sequence split
    across two drains decodes correctly instead of emitting U+FFFD."""

    def __init__(self, stream):
        import codecs

        self.stream = stream
        self._decoder = codecs.getincrementaldecoder("utf-8")("replace")
        self._queue = None
        self._thread = None
        try:
            import os

            os.set_blocking(stream.fileno(), False)
        except (OSError, AttributeError):
            import queue
            import threading

            self._queue = queue.Queue()
            self._thread = threading.Thread(target=self._pump, daemon=True)
            self._thread.start()

    def _pump(self):
        while True:
            chunk = self.stream.read(8192)
            if not chunk:
                return
            self._queue.put(chunk)

    def read(self) -> str:
        """Decoded text available right now ('' when none)."""
        if self._queue is None:
            try:
                data = self.stream.read()  # None when nothing is ready
            except (OSError, ValueError):
                data = None
        else:
            import queue

            chunks = []
            while True:
                try:
                    chunks.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            data = b"".join(chunks)
        return self._decoder.decode(data) if data else ""

    def close(self) -> str:
        """Final drain after child exit: wait out the pump thread (threaded
        mode), collect the remainder, flush the decoder tail, close.

        If the pump thread is STILL mid-read after the grace period (a
        huge final burst), the stream is left open for the daemon thread
        rather than closed out from under its blocked read — closing early
        both dropped the output tail and raised ValueError in the thread
        (r5 review); the fd is reclaimed at process exit."""
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            if self._thread.is_alive():
                return self.read() + self._decoder.decode(b"", True)
        tail = self.read() + self._decoder.decode(b"", True)
        try:
            self.stream.close()
        except OSError:
            pass
        return tail


def build_argv(tool: str, answers: dict) -> list[str]:
    argv = [tool]
    for name, _, _ in TOOLS[tool]:
        val = answers.get(name, "")
        if val in ("", None):
            continue
        if name == "files":
            argv.extend(str(val).split())
        elif name.startswith("--"):
            argv.extend([name, str(val)])
        else:
            argv.append(str(val))
    return argv


def run_tui() -> int:
    console = Console()
    table = Table(title="barcoder-tpu toolkit")
    table.add_column("Tool")
    table.add_column("What it does")
    for tool, desc in TOOL_DESCRIPTIONS.items():
        table.add_row(tool, desc)
    console.print(table)

    tool = Prompt.ask("Tool", choices=list(TOOLS.keys()), default="targets")
    answers = {}
    for name, help_text, default in TOOLS[tool]:
        answers[name] = Prompt.ask(f"{help_text}", default=default or "")
    argv = build_argv(tool, answers)
    console.print(f"[bold]Running:[/bold] barcoder-tpu {' '.join(argv)}")
    if not Confirm.ask("Proceed?", default=True):
        return 1
    from .main import main as dispatch

    return dispatch(argv)


def run_qt() -> int:  # pragma: no cover - needs a display
    """Graphical front-end: PyQt5 when installed (cli/gui_qt.py — the
    reference's extensible_GUI/targets_gui equivalent), else the tkinter
    twin (cli/gui_tk.py — stdlib, runs anywhere with a display), else the
    TUI."""
    try:
        from PyQt5.QtWidgets import QApplication  # noqa: F401

        from .gui_qt import main as qt_main

        return qt_main()
    except ImportError:
        pass
    from .gui_tk import main as tk_main

    return tk_main()


def main(argv=None) -> int:
    args = list(argv or [])
    if "--graphical" in args or "-g" in args:
        return run_qt()
    return run_tui()


if __name__ == "__main__":
    sys.exit(main())
