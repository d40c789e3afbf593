"""PyQt5 graphical front-end (reference: extensible_GUI.py:19-204 launcher +
targets_gui.py:24-301 form→argv→subprocess pattern).

Structure mirrors the reference's app at feature level:

  - a stacked-widget launcher listing the five tools (extensible_GUI.py's
    MainWindow with its tool list + back button);
  - per-tool forms generated from the shared ``gui.TOOLS`` spec (labels,
    defaults, file-picker buttons for path-like fields — targets_gui.py
    builds its form from the argparse spec the same way);
  - Run executes ``python -m barcoder_tpu_torch <argv>`` as a subprocess and
    polls it with a QTimer, streaming stdout/stderr into a read-only text
    pane (targets_gui.py:255-301's QTimer/poll pattern);
  - the window stays responsive; Run is disabled while a job is live.

PyQt5 is an optional dependency: importing this module is safe without it
(the import happens inside ``main``); ``cli.gui.run_qt`` falls back to the
Tk front-end and then the TUI when unavailable. Smoke-tested offscreen
(QT_QPA_PLATFORM=offscreen) where PyQt5 exists — see tests/test_gui.py.
"""

from __future__ import annotations

import subprocess
import sys

from .gui import TOOL_DESCRIPTIONS, TOOLS, StreamDrainer, build_argv

_PATHLIKE = ("file", "files", "genome", "fasta")


def _is_pathlike(field_name: str) -> bool:
    return any(tok in field_name for tok in _PATHLIKE)


def build_app(argv=None):
    """Construct (app, window). Separated from main() so tests can drive
    the widgets without entering the event loop."""
    from PyQt5.QtCore import QTimer
    from PyQt5.QtWidgets import (
        QApplication,
        QFileDialog,
        QFormLayout,
        QHBoxLayout,
        QLabel,
        QLineEdit,
        QMainWindow,
        QPlainTextEdit,
        QPushButton,
        QStackedWidget,
        QVBoxLayout,
        QWidget,
    )

    app = QApplication.instance() or QApplication(argv or sys.argv[:1])

    class ToolForm(QWidget):
        def __init__(self, tool: str, window: "MainWindow"):
            super().__init__()
            self.tool = tool
            self.window = window
            self.fields: dict[str, QLineEdit] = {}
            layout = QVBoxLayout(self)
            form = QFormLayout()
            for name, help_text, default in TOOLS[tool]:
                edit = QLineEdit()
                if default:
                    edit.setText(str(default))
                self.fields[name] = edit
                if _is_pathlike(name):
                    row = QHBoxLayout()
                    row.addWidget(edit)
                    browse = QPushButton("Browse…")
                    browse.clicked.connect(
                        lambda _=False, e=edit: self._pick(e, QFileDialog)
                    )
                    row.addWidget(browse)
                    form.addRow(help_text, row)
                else:
                    form.addRow(help_text, edit)
            layout.addLayout(form)
            self.run_btn = QPushButton(f"Run {tool}")
            self.run_btn.clicked.connect(self.start)
            layout.addWidget(self.run_btn)
            back = QPushButton("Back")
            back.clicked.connect(lambda: window.stack.setCurrentIndex(0))
            layout.addWidget(back)
            self.output = QPlainTextEdit()
            self.output.setReadOnly(True)
            layout.addWidget(self.output)
            self.proc: subprocess.Popen | None = None
            self.timer = QTimer(self)
            self.timer.setInterval(200)
            self.timer.timeout.connect(self.poll)

        def _pick(self, edit, QFileDialog):
            path, _ = QFileDialog.getOpenFileName(self, "Choose file")
            if path:
                edit.setText(path)

        def answers(self) -> dict:
            return {name: e.text().strip() for name, e in self.fields.items()}

        def argv(self) -> list[str]:
            return build_argv(self.tool, self.answers())

        def start(self):
            if self.proc is not None:
                return
            argv = self.argv()
            self.output.appendPlainText(f"$ barcoder-tpu {' '.join(argv)}")
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "barcoder_tpu_torch", *argv],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            )
            # incremental drain every tick: a blocked pipe (~64 KB OS
            # buffer) would otherwise deadlock any child that logs more
            # than that — it can never exit, and the old code only read
            # AFTER exit. StreamDrainer also keeps chunk boundaries out of
            # the pane (no paragraph break per drain, no split-UTF-8 U+FFFD)
            self.drainer = StreamDrainer(self.proc.stdout)
            self.run_btn.setEnabled(False)
            self.timer.start()

        def _append(self, text: str):
            if not text:
                return
            cursor = self.output.textCursor()
            cursor.movePosition(cursor.End)
            cursor.insertText(text)
            self.output.setTextCursor(cursor)

        def poll(self):
            # QTimer-polled subprocess, the targets_gui.py:255-301 pattern,
            # with incremental stdout streaming into the pane
            if self.proc is None:
                return
            self._append(self.drainer.read())
            rc = self.proc.poll()
            if rc is None:
                return
            self._append(self.drainer.close())  # remainder after exit
            self.output.appendPlainText(f"[exit {rc}]")
            self.proc = None
            self.run_btn.setEnabled(True)
            self.timer.stop()

    class MainWindow(QMainWindow):
        def __init__(self):
            super().__init__()
            self.setWindowTitle("barcoder-tpu toolkit")
            self.stack = QStackedWidget()
            self.setCentralWidget(self.stack)
            launcher = QWidget()
            lay = QVBoxLayout(launcher)
            lay.addWidget(QLabel("Choose a tool:"))
            self.stack.addWidget(launcher)
            self.forms: dict[str, ToolForm] = {}
            for i, tool in enumerate(TOOLS, start=1):
                form = ToolForm(tool, self)
                self.forms[tool] = form
                self.stack.addWidget(form)
                btn = QPushButton(f"{tool} — {TOOL_DESCRIPTIONS[tool]}")
                btn.clicked.connect(lambda _=False, idx=i: self.stack.setCurrentIndex(idx))
                lay.addWidget(btn)

    return app, MainWindow()


def main(argv=None) -> int:
    try:
        import PyQt5  # noqa: F401
    except ImportError:
        from rich.console import Console

        Console(stderr=True).print(
            "[yellow]PyQt5 is not installed; use `barcoder-tpu gui` for the "
            "Tk/terminal front-ends.[/yellow]"
        )
        return 2
    app, window = build_app(argv)
    window.show()
    return app.exec_()


if __name__ == "__main__":
    sys.exit(main())
