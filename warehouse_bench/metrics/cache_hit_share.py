"""cache_hit_share: queries answered from the result cache
(``info["cache_hit"]``) over all queries of the window."""


def read(obs):
    recs = obs["records"]
    return sum(bool(r.info.get("cache_hit")) for r in recs) / len(recs) \
        if recs else None
