"""dash_qps: queries completed by all clients, over the whole window."""


def read(obs):
    done = sum(r.error is None for r in obs["records"])
    return done / obs["window_s"] if done else None
