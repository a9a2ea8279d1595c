"""train.feed_starved_pct: the share of the window's batch fetches that
found the handler's queue empty (the program's queue counters)."""


def read(record):
    if record.get('kind') != 'train' or not record['feed_gets']:
        return None
    return 100.0 * record['feed_starved'] / record['feed_gets']
