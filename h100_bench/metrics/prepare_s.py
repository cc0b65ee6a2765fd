"""Host seconds of the port's preparation: ``cli.apply_dataset_surgery``
and the graph build (``graph.prepare_graph``), host clock."""


def read(r):
    return r["setup"].get("prepare_s")
