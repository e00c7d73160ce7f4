"""ms a step in the span `collide` (spans/collide.json), synchronized split."""

from benchmark.metrics import span_ms

SPANS = ("collide",)


def read(record):
    return span_ms(record, SPANS[0])
