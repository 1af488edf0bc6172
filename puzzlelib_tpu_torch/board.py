"""Graphviz rendering of nets from blueprints (counterpart of
``puzzlelib_tpu/board.py``): ``drawBoard`` walks ``net.getBlueprint()`` and
gives the JAX package's DOT source for the same net.  ``graphviz`` is
imported inside ``drawBoard`` only, so the module imports without it;
rendering also needs its ``dot`` binary."""


def drawBoard(net, filename, view=True, fmt="svg", modulesOnly=False, name=None, fontname="Consolas",
              fullnames=True):
    """Write ``net``'s DOT source to ``filename`` and render it in ``fmt``;
    ``view`` also opens the rendering."""
    from graphviz import Digraph

    if name is None:
        name = net.name

    g = Digraph(name, filename=filename)
    g.format = fmt

    g.attr(label=name, labelloc="top", labeljust="center", fontcolor="#31343F", fontname=fontname)
    g.edge_attr.update(color="#31343F")
    g.node_attr.update(style="filled", color="#CA5237", shape="Mrecord", fontname=fontname,
                       fontcolor="white", fontsize="8")

    blueprint = net.getBlueprint()
    drawGraph(g, blueprint, childName=name, modulesOnly=modulesOnly, fullnames=fullnames)

    g.view(filename) if view else g.render(filename)


def _buildLabel(classname, params, name, showFullname, container):
    head = '<table border="0" cellspacing="5" bgcolor="#FFB84D" style="rounded">' if container \
        else '<table cellspacing="0">'

    label = "<%s<tr><td align=\"center\" colspan=\"2\"><font point-size=\"10\">%s</font></td></tr>" \
        % (head, classname)

    params = dict(params)
    if showFullname:
        params["fullname"] = name

    for paramName in sorted(params.keys()):
        color = "#31343F" if (not container and paramName == "name") else "white"

        if container:
            label += "<tr><td align=\"left\">%s</td><td align=\"right\">%s</td></tr>" \
                % (paramName, params[paramName])
        else:
            label += "<tr><td align=\"left\"><font color=\"%s\">%s</font></td>" \
                     "<td align=\"right\"><font color=\"%s\">%s</font></td></tr>" \
                     % (color, paramName, color, params[paramName])

    return label + "</table>>"


def buildContainerLabel(classname, params, name, showFullname):
    return _buildLabel(classname, params, name, showFullname, container=True)


def buildModuleLabel(classname, params, name, showFullname):
    return _buildLabel(classname, params, name, showFullname, container=False)


def drawGraph(g, blueprint, parentName=None, childName=None, clusterIdx=0, modulesOnly=False, fullnames=True):
    classname = blueprint["classname"]
    scheme = blueprint["scheme"]

    name = "%s.%s" % (parentName, childName) if parentName is not None else str(childName)

    if classname not in {"Sequential", "Parallel", "Graph"}:
        g.node(name, label=buildModuleLabel(classname, scheme, name, fullnames))
        return clusterIdx, [name], [name]

    graph, elements = blueprint["graph"], blueprint["modules"]

    with g.subgraph(name="cluster_%s" % clusterIdx) as c:
        clusterIdx += 1

        if not modulesOnly:
            c.attr(label=buildContainerLabel(classname, {"name": scheme["name"]}, name, fullnames),
                   labeljust="right", shape="Mrecord", color="#31343F",
                   fontcolor="#554037", fontsize="8", rankdir="TB")
        else:
            c.attr(color="#FFFFFF", fontcolor="#FFFFFF")

        inNodes, outNodes = [], []

        if classname == "Sequential":
            if len(graph) > 0:
                clusterIdx, inNodes, outNodes = drawGraph(
                    c, elements[graph[0]], parentName=name, childName=graph[0], clusterIdx=clusterIdx,
                    modulesOnly=modulesOnly, fullnames=fullnames
                )

            curOutNodes = outNodes
            for nm in graph[1:]:
                clusterIdx, newInNodes, outNodes = drawGraph(
                    c, elements[nm], parentName=name, childName=nm, clusterIdx=clusterIdx,
                    modulesOnly=modulesOnly, fullnames=fullnames
                )
                connectNodes(c, curOutNodes, newInNodes)
                curOutNodes = outNodes

            return clusterIdx, [inNode + ":w" for inNode in inNodes if isinstance(inNode, str)], outNodes

        elif classname == "Parallel":
            for nm in graph:
                clusterIdx, newInNodes, newOutNodes = drawGraph(
                    c, elements[nm], parentName=name, childName=nm, clusterIdx=clusterIdx,
                    modulesOnly=modulesOnly, fullnames=fullnames
                )
                inNodes.append(newInNodes)
                outNodes.append(newOutNodes)

            return clusterIdx, inNodes, outNodes

        else:  # Graph
            inputs, outputs = set(blueprint["inputs"]), set(blueprint["outputs"])
            nodes = {}

            for nm, mod in elements.items():
                _, newInNodes, newOutNodes = drawGraph(
                    c, mod, parentName=name, childName=nm, clusterIdx=clusterIdx,
                    modulesOnly=modulesOnly, fullnames=fullnames
                )
                nodes[nm] = (newInNodes, newOutNodes)

                if nm in inputs:
                    inNodes.extend(newInNodes)
                if nm in outputs:
                    outNodes.extend(newOutNodes)

            for nm, node in nodes.items():
                connectNodes(c, [nodes[srcname][0] for srcname, _ in graph[nm]], node[1])

            return clusterIdx, inNodes, outNodes


def connectNodes(g, inNodes, outNodes):
    if isinstance(inNodes, str):
        if isinstance(outNodes, str):
            g.edges([(inNodes, outNodes)])
        else:
            for outNode in outNodes:
                connectNodes(g, inNodes, outNode)

    elif isinstance(outNodes, str):
        for inNode in inNodes:
            connectNodes(g, inNode, outNodes)

    elif len(inNodes) == len(outNodes):
        for j, node in enumerate(outNodes):
            connectNodes(g, inNodes[j], node)

    elif len(inNodes) == 1:
        for node in outNodes:
            connectNodes(g, inNodes[0], node)

    elif len(outNodes) == 1:
        for node in inNodes:
            connectNodes(g, node, outNodes[0])

    else:
        assert False
