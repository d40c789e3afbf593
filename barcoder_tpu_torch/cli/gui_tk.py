"""Tkinter graphical front-end — the always-available graphical twin of
cli/gui_qt.py (tkinter ships with CPython, so this runs on any machine
with a display, no optional dependency).

Same structure as the reference's PyQt5 app (extensible_GUI.py launcher +
targets_gui.py form→argv→subprocess with timer polling), built on the
shared ``gui.TOOLS`` form spec and ``gui.build_argv``: a tool listbox, a
generated per-tool form with file pickers, a Run button that launches
``python -m barcoder_tpu_torch <argv>`` as a subprocess, and an ``after``-polled
output pane (Tk's equivalent of the QTimer pattern)."""

from __future__ import annotations

import subprocess
import sys

from .gui import TOOL_DESCRIPTIONS, TOOLS, StreamDrainer, build_argv
from .gui_qt import _is_pathlike


def build_app(root=None):
    """Construct (root, app dict). Separated from main() so tests can
    drive the widgets without entering the event loop."""
    import tkinter as tk
    from tkinter import filedialog, ttk

    root = root or tk.Tk()
    root.title("barcoder-tpu toolkit")
    container = ttk.Frame(root, padding=8)
    container.grid(sticky="nsew")
    root.columnconfigure(0, weight=1)
    root.rowconfigure(0, weight=1)

    frames: dict[str, ttk.Frame] = {}
    state = {"tool": None}
    # per-tool process/drainer (like the Qt twin's per-ToolForm proc):
    # a single shared slot made every other tool's enabled Run button a
    # silent no-op while one ran (r5 review)
    procs: dict = {}
    drainers: dict = {}

    def show(name: str):
        for f in frames.values():
            f.grid_remove()
        frames[name].grid(row=0, column=0, sticky="nsew")
        state["tool"] = None if name == "launcher" else name

    launcher = ttk.Frame(container)
    frames["launcher"] = launcher
    ttk.Label(launcher, text="Choose a tool:").grid(sticky="w")

    fields: dict[str, dict[str, tk.Entry]] = {}
    outputs: dict[str, tk.Text] = {}
    run_btns: dict[str, ttk.Button] = {}

    def answers(tool: str) -> dict:
        return {n: e.get().strip() for n, e in fields[tool].items()}

    def argv_for(tool: str) -> list[str]:
        return build_argv(tool, answers(tool))

    def poll(tool: str):
        # incremental drain — a full OS pipe (~64 KB) would block the
        # child forever if we only read after exit; StreamDrainer handles
        # non-blocking reads (or a reader thread where unsupported) and
        # incremental UTF-8 decoding
        proc = procs.get(tool)
        if proc is None:
            return
        outputs[tool].insert("end", drainers[tool].read())
        rc = proc.poll()
        if rc is None:
            root.after(200, lambda: poll(tool))
            return
        outputs[tool].insert("end", drainers[tool].close())
        outputs[tool].insert("end", f"[exit {rc}]\n")
        procs[tool] = None
        run_btns[tool].state(["!disabled"])

    def start(tool: str):
        if procs.get(tool) is not None:
            return
        argv = argv_for(tool)
        outputs[tool].insert("end", f"$ barcoder-tpu {' '.join(argv)}\n")
        procs[tool] = subprocess.Popen(
            [sys.executable, "-m", "barcoder_tpu_torch", *argv],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        drainers[tool] = StreamDrainer(procs[tool].stdout)
        run_btns[tool].state(["disabled"])
        root.after(200, lambda: poll(tool))

    for i, tool in enumerate(TOOLS, start=1):
        frame = ttk.Frame(container)
        frames[tool] = frame
        fields[tool] = {}
        for r, (name, help_text, default) in enumerate(TOOLS[tool]):
            ttk.Label(frame, text=help_text).grid(row=r, column=0, sticky="w")
            entry = ttk.Entry(frame, width=48)
            if default:
                entry.insert(0, str(default))
            entry.grid(row=r, column=1, sticky="ew")
            fields[tool][name] = entry
            if _is_pathlike(name):
                def pick(e=entry):
                    path = filedialog.askopenfilename(title="Choose file")
                    if path:
                        e.delete(0, "end")
                        e.insert(0, path)

                ttk.Button(frame, text="Browse…", command=pick).grid(
                    row=r, column=2
                )
        nrows = len(TOOLS[tool])
        run_btn = ttk.Button(frame, text=f"Run {tool}", command=lambda t=tool: start(t))
        run_btn.grid(row=nrows, column=0, pady=4, sticky="w")
        run_btns[tool] = run_btn
        ttk.Button(frame, text="Back", command=lambda: show("launcher")).grid(
            row=nrows, column=1, pady=4, sticky="w"
        )
        box = tk.Text(frame, height=12, width=80)
        box.grid(row=nrows + 1, column=0, columnspan=3, sticky="nsew")
        outputs[tool] = box
        ttk.Button(
            launcher,
            text=f"{tool} — {TOOL_DESCRIPTIONS[tool]}",
            command=lambda t=tool: show(t),
        ).grid(row=i, column=0, sticky="ew", pady=2)

    show("launcher")
    app = {
        "frames": frames,
        "fields": fields,
        "outputs": outputs,
        "argv_for": argv_for,
        "show": show,
        "start": start,
        "state": state,
    }
    return root, app


def main(argv=None) -> int:
    try:
        root, _app = build_app()
    except Exception as e:  # no display / no tkinter
        from rich.console import Console

        Console(stderr=True).print(
            f"[yellow]Tk front-end unavailable ({e}); falling back to the "
            "terminal UI.[/yellow]"
        )
        from .gui import run_tui

        return run_tui()
    root.mainloop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
