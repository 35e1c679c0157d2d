"""Mean device time of ``apply_updates`` a step in the window (CUDA
events around the call, traced runs only).
Returns None where the run has nothing to read."""


def read(run):
    spans = run.spans.get("optimizer_s") if run.kind == "train" else None
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
