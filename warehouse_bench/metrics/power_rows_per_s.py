"""power_rows_per_s: lineorder rows in the input of every query the window
completed (the table's row count per query), over the whole window."""


def read(obs):
    done = sum(r.error is None for r in obs["records"])
    return obs["lineorder_rows"] * done / obs["window_s"] if done else None
