"""plan_ms: mean over the window's queries of the pipeline's host stages
(``cursor.info["stage_times_ms"]``: parse, bind, cache probe, view
rewrite, optimize, compile), all but execute."""


def read(obs):
    per = [sum(v for k, v in r.info["stage_times_ms"].items()
               if k != "execute")
           for r in obs["records"] if r.info.get("stage_times_ms")]
    return sum(per) / len(per) if per else None
