/* Public C API of the tdxgraph native engine.
 *
 * Counterpart of the reference's installed public headers
 * (reference src/cc/torchdistx/{fake,deferred_init}.h, installed by its
 * src/cc/torchdistx/CMakeLists.txt) — but as a flat C ABI so it is
 * consumable from ctypes (torchdistx_tpu_torch/_native.py), C, or C++ without
 * any torch/ABI coupling.
 *
 * Thread safety: every call locks the graph's internal mutex; handles may
 * be shared across threads.  Node ids are stable for the graph's
 * lifetime; 0 is never a valid id.
 */
#ifndef TDX_GRAPH_H
#define TDX_GRAPH_H

#include <stdint.h>

#if defined(_WIN32)
#ifdef TDX_BUILDING_DLL /* defined when compiling the library itself */
#define TDX_PUBLIC __declspec(dllexport)
#else
#define TDX_PUBLIC __declspec(dllimport)
#endif
#else
#define TDX_PUBLIC
#endif

#ifdef __cplusplus
extern "C" {
#endif

/* Create / destroy an operation graph. */
TDX_PUBLIC void* tdx_graph_create(void);
TDX_PUBLIC void tdx_graph_destroy(void* graph);

/* Create a node (returns its id; op_nr ordering is creation order). */
TDX_PUBLIC uint64_t tdx_node_create(void* graph);

/* Destroy a node, erasing its back-edges from its dependencies. */
TDX_PUBLIC void tdx_node_destroy(void* graph, uint64_t id);

/* Record that output storage `key` belongs to node `id` (alias key). */
TDX_PUBLIC void tdx_node_add_storage(void* graph, uint64_t id, uint64_t key);

/* Record a dependency: node `id` consumes output `out_idx` of `dep_id`. */
TDX_PUBLIC void tdx_node_add_dep(void* graph, uint64_t id, uint64_t dep_id,
                                 int32_t out_idx);

/* Mark a node (not) materialized; materialized nodes are pruned from
 * call-stack builds. */
TDX_PUBLIC void tdx_node_set_materialized(void* graph, uint64_t id,
                                          int32_t value);

/* Last (by op_nr) node whose outputs alias `id`'s storages — the replay
 * horizon for in-place chains. */
TDX_PUBLIC uint64_t tdx_last_in_place(void* graph, uint64_t id);

/* Write up to `cap` node ids (chronological replay order for
 * materializing `id`) into `out`; returns the total count — call again
 * with a larger buffer if the count exceeds `cap`. */
TDX_PUBLIC uint64_t tdx_build_call_stack(void* graph, uint64_t id,
                                         uint64_t* out, uint64_t cap);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* TDX_GRAPH_H */
