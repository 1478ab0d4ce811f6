"""data_wait_share.train: the share of the window the training loop spent in
``next()`` on the ``DevicePrefetcher`` (harness clock around each call)."""


def read(run):
    share = run.data.get("data_wait_share")
    return None if share is None else 100.0 * share
