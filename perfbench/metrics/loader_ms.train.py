"""Mean host time of ``next()`` on the job's batch iterator a step in
the window: the token store's span decode and the put to the card.
Returns None where the run has nothing to read."""


def read(run):
    spans = run.spans.get("loader_s") if run.kind == "train" else None
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
