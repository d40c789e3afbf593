"""count.card_ms_per_mread: the card's time for the matching and its copies
(CUDA events: the growth of ``CudaCounter.device_ms`` over each sample) per
million reads counted."""


def read(run):
    reads = sum(it.work["reads"] for it in run.items) if run.unit == "sample" else 0
    card_ms = sum(it.work["card_ms"] for it in run.items)
    return 1e6 * card_ms / reads if reads and card_ms > 0 else None
