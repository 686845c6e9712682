// Host emulation of the thread-block cluster of cooperative_groups
// (this_cluster, block_rank, num_blocks, sync, map_shared_rank) for the
// blocks that shim.h runs at once as one cluster.
#pragma once
#include "shim.h"

namespace cooperative_groups {

struct cluster_group {
  unsigned block_rank() const { return (unsigned)emu_cluster_rank; }
  unsigned num_blocks() const { return (unsigned)emu_cluster_size; }
  // every thread of every block of the cluster meets here
  void sync() const { emu_cluster_bar->arrive_and_wait(); }
  // the address in block `rank`'s shared memory of what p is in this one's
  template <typename T> T* map_shared_rank(T* p, unsigned rank) const {
    const size_t off = (const unsigned char*)p - emu_smem;
    if (off >= kEmuSmem || (int)rank >= emu_cluster_size) {
      fprintf(stderr, "map_shared_rank: offset %zu rank %u of %d\n", off, rank,
              emu_cluster_size);
      exit(4);
    }
    return (T*)(emu_smem_pool[rank] + off);
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
