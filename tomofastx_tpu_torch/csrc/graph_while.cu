// LSQR's minor loop as a CUDA WHILE node inside the fused major's graph, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package the fused major loop is one
// XLA program whose LSQR is a lax.while_loop (tomofastx_tpu/ops/lsqr.py:
// 107-161, inside tomofastx_tpu/inversion/joint.py:421 make_fused_solver). It
// stops at the first exit test that holds. A torch graph captures a fixed
// list of launches, so the port captures a major as three torch graphs (head:
// the major up to LSQR's first products and the loop's first condition; body:
// one LSQR iteration, which writes the next condition into a one-byte flag;
// tail: the rest of the major) and joins them here into one parent graph:
//
//   head -> set_condition -> WHILE { body -> set_condition } -> tail
//
// set_condition is the one kernel of this file: one thread that sets the
// WHILE node's condition to (*go && runs < max_iter). After the head it reads
// the counter as the head left it (zeroed); in the body it first adds one to
// it, so that after a launch the counter holds the body's runs. The cap keeps
// a flag that never falls from looping without end.
//
// What bounds it: nothing of the card's rates: it reads one byte and one int
// and writes one int. A WHILE iteration costs the body's launches plus this
// kernel's, all inside the graph, with no read of the device by the host.
//
// Plain C entry points, loaded with ctypes; each returns a cudaError_t (0 on
// success), whose text graph_while_error gives.

#include <cuda_runtime.h>

__global__ void set_condition(cudaGraphConditionalHandle handle, const unsigned char* go, int* runs, int max_iter,
                              int count) {
    int n = *runs + count;
    if (count) *runs = n;
    cudaGraphSetConditional(handle, (*go != 0 && n < max_iter) ? 1u : 0u);
}

namespace {

cudaError_t add_set_condition(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* after,
                              cudaGraphConditionalHandle handle, const unsigned char* go, int* runs, int max_iter,
                              int count) {
    void* args[] = {&handle, &go, &runs, &max_iter, &count};
    cudaKernelNodeParams p = {};
    p.func = reinterpret_cast<void*>(set_condition);
    p.gridDim = dim3(1);
    p.blockDim = dim3(1);
    p.sharedMemBytes = 0;
    p.kernelParams = args;
    p.extra = nullptr;
    return cudaGraphAddKernelNode(node, graph, after, 1, &p);
}

cudaError_t add_nodes(cudaGraph_t parent, cudaGraph_t head, cudaGraph_t body, cudaGraph_t tail,
                      const unsigned char* go, int* runs, int max_iter) {
    cudaError_t err;
    cudaGraphConditionalHandle handle;
    if ((err = cudaGraphConditionalHandleCreate(&handle, parent, 0, 0)) != cudaSuccess) return err;
    // Each torch graph is cloned into a child graph node.
    cudaGraphNode_t head_node, first, loop_node, tail_node, body_node, next;
    if ((err = cudaGraphAddChildGraphNode(&head_node, parent, nullptr, 0, head)) != cudaSuccess) return err;
    if ((err = add_set_condition(&first, parent, &head_node, handle, go, runs, max_iter, 0)) != cudaSuccess) return err;
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    if ((err = cudaGraphAddNode(&loop_node, parent, &first, 1, &cp)) != cudaSuccess) return err;
    cudaGraph_t loop = cp.conditional.phGraph_out[0];
    if ((err = cudaGraphAddChildGraphNode(&body_node, loop, nullptr, 0, body)) != cudaSuccess) return err;
    if ((err = add_set_condition(&next, loop, &body_node, handle, go, runs, max_iter, 1)) != cudaSuccess) return err;
    return cudaGraphAddChildGraphNode(&tail_node, parent, &loop_node, 1, tail);
}

}  // namespace

// The parent graph of the three graphs (head, body and tail: cudaGraph_t of
// torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()), instantiated. On
// success *parent_out and *exec_out hold what graph_while_destroy frees; on
// an error nothing is left to free.
extern "C" int graph_while_build(void* head, void* body, void* tail, const void* go, void* runs, int max_iter,
                                 void** parent_out, void** exec_out) {
    cudaGraph_t parent = nullptr;
    cudaGraphExec_t exec = nullptr;
    cudaError_t err = cudaGraphCreate(&parent, 0);
    if (err != cudaSuccess) return err;
    err = add_nodes(parent, static_cast<cudaGraph_t>(head), static_cast<cudaGraph_t>(body),
                    static_cast<cudaGraph_t>(tail), static_cast<const unsigned char*>(go), static_cast<int*>(runs),
                    max_iter);
    if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, parent, 0);
    if (err != cudaSuccess) {
        cudaGraphDestroy(parent);
        return err;
    }
    *parent_out = parent;
    *exec_out = exec;
    return cudaSuccess;
}

// One launch of the instantiated parent graph on `stream`: one major.
extern "C" int graph_while_launch(void* exec, void* stream) {
    return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

// Frees what graph_while_build made: the instantiated graph, then the parent.
extern "C" int graph_while_destroy(void* parent, void* exec) {
    cudaError_t a = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
    cudaError_t b = cudaGraphDestroy(static_cast<cudaGraph_t>(parent));
    return a != cudaSuccess ? a : b;
}

extern "C" const char* graph_while_error(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
