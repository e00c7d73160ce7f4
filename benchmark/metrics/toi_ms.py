"""ms a step in the span `toi` (spans/toi.json), synchronized split."""

from benchmark.metrics import span_ms

SPANS = ("toi",)


def read(record):
    return span_ms(record, SPANS[0])
