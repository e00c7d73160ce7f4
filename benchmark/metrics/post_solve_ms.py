"""ms a step in the span `post_solve` (spans/post_solve.json), synchronized split."""

from benchmark.metrics import span_ms

SPANS = ("post_solve",)


def read(record):
    return span_ms(record, SPANS[0])
