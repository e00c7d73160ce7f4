"""ms a step in the span `solve` (spans/solve.json), synchronized split."""

from benchmark.metrics import span_ms

SPANS = ("solve",)


def read(record):
    return span_ms(record, SPANS[0])
