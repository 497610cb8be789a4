"""CUDA graph helpers of the GPU tests: a call captured into a graph that
keeps its nodes, and the count of its kernel nodes (a call's device
launches, counted on the card)."""
import ctypes

import torch


def captured(fn):
    """fn run once on a side stream, then captured into a CUDA graph (kept
    for kernel_nodes): (graph, fn's result in the graph's memory)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    graph.instantiate()
    return graph, out


def kernel_nodes(graph):
    """The kernel nodes of a captured graph (libcuda's cuGraphGetNodes and
    cuGraphNodeGetType; CU_GRAPH_NODE_TYPE_KERNEL is 0)."""
    cu = ctypes.CDLL("libcuda.so.1")
    h = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(h, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(h, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        t = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(t)) == 0
        kinds.append(t.value)
    return kinds.count(0)
