"""Net topology visualization (draw_net equivalent).

A copy of `mscnn_tpu/utils/draw.py` (jax-free), on the port's
`config/prototxt.py`.

Covers the reference's python/caffe/draw.py:1-232 (`get_pydot_graph` /
`draw_net_to_file`): layers become record nodes labeled with type and the
salient hyper-parameters (conv kernel/stride/pad, pooling mode), blobs
become octagon nodes, and in-place chains collapse onto the blob node —
the same topology rules, but emitting Graphviz DOT text directly instead
of going through pydot (no dependency on the graphviz binary;
`dot -Tpng net.dot -o net.png` renders it anywhere graphviz exists).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from mscnn_torch.config import prototxt as PB

LAYER_COLOR = "#6495ED"     # draw.py:26
NEURON_COLOR = "#90EE90"    # activation-ish layers, draw.py:28-29
BLOB_COLOR = "#E0E0E0"      # draw.py:31-32

_NEURON_TYPES = {"ReLU", "PReLU", "ELU", "Sigmoid", "TanH", "BNLL",
                 "AbsVal", "Power", "Exp", "Log", "Threshold", "Dropout"}


def _layer_label(layer: PB.Message) -> str:
    """Name, type, and conv/pool hyper-params (draw.py:62-114)."""
    name = str(layer.get("name"))
    ltype = str(layer.get("type"))
    if ltype in ("Convolution", "Deconvolution"):
        cp = layer.get("convolution_param", {})
        k = cp.get("kernel_size", cp.get("kernel_h", 3))
        return (f"{name}\\n({ltype})\\nkernel: {k}  stride: "
                f"{cp.get('stride', 1)}  pad: {cp.get('pad', 0)}")
    if ltype == "Pooling":
        pp = layer.get("pooling_param", {})
        return (f"{name}\\n({ltype} {pp.get('pool', 'MAX')})\\nkernel: "
                f"{pp.get('kernel_size', 2)}  stride: "
                f"{pp.get('stride', pp.get('kernel_size', 2))}")
    return f"{name}\\n({ltype})"


def _edge_label(layer: PB.Message) -> str:
    """Output width on layer->blob edges (draw.py:46-59)."""
    ltype = str(layer.get("type"))
    if ltype in ("Convolution", "Deconvolution"):
        return str(layer.get("convolution_param", {}).get("num_output", ""))
    if ltype == "InnerProduct":
        return str(layer.get("inner_product_param", {}).get("num_output", ""))
    if ltype == "Data":
        bs = layer.get("data_param", {}).get("batch_size", "")
        return f"Batch {bs}" if bs != "" else ""
    return ""


def to_dot(net: PB.Message, rankdir: str = "LR",
           phase: Optional[str] = None, label_edges: bool = True) -> str:
    """NetParameter message -> Graphviz DOT text.

    phase: None (all layers) or "TRAIN"/"TEST" (NetState include rules,
    draw.py:152-163)."""
    name = str(net.get("name", "net"))
    nodes: Dict[str, str] = {}
    edges: List[str] = []

    def blob_node(blob: str) -> str:
        nid = f"blob_{blob}"
        nodes.setdefault(
            nid, f'"{nid}" [label="{blob}", shape=octagon, '
                 f'style=filled, fillcolor="{BLOB_COLOR}"];')
        return nid

    for layer in PB.layers(net):
        lphase = PB.layer_phase(layer)
        if phase is not None and lphase not in (phase, "BOTH"):
            continue
        lname = str(layer.get("name"))
        ltype = str(layer.get("type"))
        bottoms = [str(b) for b in PB.as_list(layer.get("bottom"))]
        tops = [str(t) for t in PB.as_list(layer.get("top"))]

        if ltype in _NEURON_TYPES and len(bottoms) == 1 and tops == bottoms:
            # in-place layer: annotate the blob, no separate node
            # (draw.py's pydot version keeps a node; collapsing reads
            # better and preserves topology)
            nid = blob_node(bottoms[0])
            edges.append(f'"{nid}" -> "{nid}" '
                         f'[label="{ltype}", style=dotted];')
            continue

        lid = f"layer_{lname}"
        color = NEURON_COLOR if ltype in _NEURON_TYPES else LAYER_COLOR
        nodes[lid] = (f'"{lid}" [label="{_layer_label(layer)}", '
                      f'shape=record, style=filled, '
                      f'fillcolor="{color}"];')
        for b in bottoms:
            edges.append(f'"{blob_node(b)}" -> "{lid}";')
        elabel = _edge_label(layer) if label_edges else ""
        attr = f' [label="{elabel}"]' if elabel else ""
        for t in tops:
            edges.append(f'"{lid}" -> "{blob_node(t)}"{attr};')

    body = "\n  ".join(list(nodes.values()) + edges)
    return (f'digraph "{name}" {{\n  rankdir={rankdir};\n  '
            f'{body}\n}}\n')


def draw_net_to_file(net: PB.Message, path: str, rankdir: str = "LR",
                     phase: Optional[str] = None) -> None:
    """Write DOT text (draw.py:226-232 writes rendered bytes; rendering
    needs the graphviz binary, which may be absent — the .dot is the portable
    artifact)."""
    with open(path, "w") as f:
        f.write(to_dot(net, rankdir=rankdir, phase=phase))
