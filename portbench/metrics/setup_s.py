"""setup_s: seconds from the process's start to its first timed request:
imports, the card's start, the inputs made from the seed, kernel builds
where the checkout has none yet, and the warm-up requests."""


def read(run):
    return run.setup_s
