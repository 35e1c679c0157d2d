"""Mean time a batch spends before its first ``lm.decode_step`` call:
the prefill and its first sampled token, which the engine reads back
(host clock, traced runs only).
Returns None where the run has nothing to read."""


def read(run):
    spans = run.spans.get("prefill_s") if run.kind == "serve_batch" \
        else None
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
