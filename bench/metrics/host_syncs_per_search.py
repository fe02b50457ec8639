"""host_syncs_per_search: the synchronizing calls (host reads and waits
on the card) of one cycle of the keys, counted under
``torch.cuda.set_sync_debug_mode("warn")``, a search."""


def read(run):
    if run.syncs is None or not run.sync_searches:
        return None
    return run.syncs / run.sync_searches
