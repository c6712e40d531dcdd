"""graph_nodes: the run program's top-level nodes and the nodes of its
WHILE bodies (Program.nodes + body_nodes); None where none was
captured."""


def read(ctx):
    p = ctx.program
    return None if p is None else p.nodes + p.body_nodes
