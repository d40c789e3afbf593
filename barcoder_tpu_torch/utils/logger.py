"""Rich-console logger with the reference's observability contract
(Logger.py:12-94): RichHandler on stderr, custom SUBPROC (25) and HELP (15)
levels, locale-aware number formatting of numeric tokens, pretty JSON dumps.
stdout stays reserved for machine-readable TSV/JSON output.
"""

from __future__ import annotations

import json
import locale
import logging
import re

# a number standing alone between whitespace (or string edges): plain,
# decimal, or exponent form
_NUM_TOKEN = re.compile(
    r"(?<!\S)[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?(?!\S)"
)

from rich.console import Console
from rich.highlighter import JSONHighlighter
from rich.logging import RichHandler
from rich.theme import Theme

try:
    from babel.numbers import format_decimal

    _HAVE_BABEL = True
except ImportError:  # pragma: no cover
    _HAVE_BABEL = False

SUBPROC = 25
HELP = 15

_console: Console | None = None


def get_console() -> Console:
    global _console
    if _console is None:
        _console = Console(
            stderr=True,
            theme=Theme(
                {
                    "logging.level.subproc": "bold blue",
                    "logging.level.help": "bold green",
                }
            ),
        )
    return _console


class Logger:
    """Mixin/standalone logger mirroring the reference Logger class."""

    SUBPROC = SUBPROC
    HELP = HELP

    def __init__(self):
        self.user_locale = locale.getlocale()[0]
        console = get_console()
        root = logging.getLogger("barcoder_tpu")
        if not root.handlers:
            handler = RichHandler(console=console)
            handler.setFormatter(logging.Formatter("%(message)s", datefmt="[%X]"))
            root.addHandler(handler)
            root.propagate = False
        # explicit level: with propagate=False the effective level would
        # otherwise inherit the root default (WARNING) and drop info logs
        root.setLevel(logging.DEBUG)
        self.logger = root
        logging.addLevelName(SUBPROC, "SUBPROC")
        logging.addLevelName(HELP, "HELP")

    def _locale_number(self, token: str):
        """One numeric token (as matched text) → its grouped rendering
        (babel when available, else exact Python grouping). Works from the
        TOKEN, not a float: the '{:,g}' fallback rendered integers >= 1e6
        in scientific notation and rounded decimals to 6 significant
        digits (r5 review — babel is not a declared dependency, so the
        fallback IS the default-install path)."""
        if _HAVE_BABEL and self.user_locale:
            try:
                return format_decimal(float(token), locale=self.user_locale)
            except Exception:
                pass
        if "e" in token or "E" in token:  # sci-notation tokens stay as-is
            return f"{float(token):,g}"
        neg = token.startswith("-")
        body = token.lstrip("+-")
        int_part, dot, frac = body.partition(".")
        grouped = f"{int(int_part or 0):,d}"
        out = grouped + (dot + frac if dot else "")
        return ("-" if neg else "") + out

    def format_numbers(self, message):
        """Locale-format every standalone numeric token of a message.

        Behavioral contract only from the reference (Logger.py:39-60: any
        whitespace-delimited token that reads as a number gets grouped
        digits); implemented as a single regex substitution over the raw
        string, which also preserves the original whitespace."""
        if isinstance(message, str):
            return _NUM_TOKEN.sub(
                lambda m: str(self._locale_number(m.group())), message
            )
        if isinstance(message, int):
            return str(self._locale_number(str(message)))
        return message

    def info(self, message):
        self.logger.info(self.format_numbers(message))

    def debug(self, message):
        self.logger.debug(self.format_numbers(message))

    def warn(self, message):
        self.logger.warning(self.format_numbers(message))

    warning = warn

    def error(self, message):
        self.logger.error(self.format_numbers(message))

    def subproc(self, message):
        message = self.format_numbers(message) or "No errors reported"
        if self.logger.isEnabledFor(SUBPROC):
            self.logger.log(SUBPROC, message)

    def help(self, message):
        message = self.format_numbers(message) or "No help available"
        if self.logger.isEnabledFor(HELP):
            self.logger.log(HELP, message)

    def json(self, data):
        self.logger.info(
            json.dumps(data, indent=4), extra={"highlighter": JSONHighlighter()}
        )
