// Native page index of the port's paged KV pool: the free list, each
// request's page ids and offset, and the -1-padded int32 block tables the
// paged kernels read, kept in C++ so a decode step's host bookkeeping
// (O(requests * width)) runs without Python object churn.
//
// The port's own copy of the JAX package's csrc/page_allocator.cpp (the
// same flat C ABI, loaded with ctypes: no pybind11), built by
// tiny_llm_tpu_torch/native/build.py. Semantics are those of the port's
// Python pool (tiny_llm_tpu_torch/kv/paged.py): page 0 is the reserved
// trash page, free pages pop last-in first-out from [P-1, ..., 1], a
// rewind frees whole trailing pages only. Changes from the JAX copy, so a
// step's bookkeeping costs one call where the wrapper needs one answer:
// pa_request_advance and pa_request_rewind refuse (return -1, changing
// nothing) an advance past the ensured pages and a rewind past the offset,
// which the wrapper raises as the Python pool does; pa_fill_offsets reads
// a batch's offsets in one call; pa_reset frees every page and keeps the
// reuse ledger, as the Python pool's reset does.

#include <cstdint>
#include <vector>

namespace {

struct Request {
  std::vector<int32_t> pages;
  int32_t offset = 0;
  bool live = false;
};

struct Pool {
  int32_t num_pages;
  std::vector<int32_t> free_list;          // LIFO, like the Python pool
  std::vector<uint8_t> ever_allocated;
  int64_t reused = 0;
  std::vector<Request> requests;
  std::vector<int32_t> request_free;       // recycled request handles

  explicit Pool(int32_t n) : num_pages(n), ever_allocated(n, 0) {
    free_list.reserve(n);
    for (int32_t p = 1; p < n; ++p) free_list.push_back(p);
    // LIFO pop from the back == Python's list(range(n-1, 0, -1)).pop():
    // both hand out page 1 first.
    std::vector<int32_t> rev(free_list.rbegin(), free_list.rend());
    free_list.swap(rev);
  }

  int32_t alloc() {
    if (free_list.empty()) return -1;
    int32_t p = free_list.back();
    free_list.pop_back();
    if (ever_allocated[p]) ++reused;
    ever_allocated[p] = 1;
    return p;
  }

  void free_page(int32_t p) { free_list.push_back(p); }
};

}  // namespace

extern "C" {

void* pa_create(int32_t num_pages) { return new Pool(num_pages); }

void pa_destroy(void* h) { delete static_cast<Pool*>(h); }

int32_t pa_alloc(void* h) { return static_cast<Pool*>(h)->alloc(); }

void pa_free(void* h, int32_t page) { static_cast<Pool*>(h)->free_page(page); }

int32_t pa_free_count(void* h) {
  return static_cast<int32_t>(static_cast<Pool*>(h)->free_list.size());
}

int64_t pa_reused_count(void* h) { return static_cast<Pool*>(h)->reused; }

// Every page but the trash page free again, in the order of a new pool;
// the reuse ledger (which pages were ever handed out, how many reuses) and
// the request handles stay.
void pa_reset(void* h) {
  Pool* pool = static_cast<Pool*>(h);
  pool->free_list.clear();
  for (int32_t p = pool->num_pages - 1; p >= 1; --p) pool->free_list.push_back(p);
}

int32_t pa_request_create(void* h) {
  Pool* pool = static_cast<Pool*>(h);
  int32_t idx;
  if (!pool->request_free.empty()) {
    idx = pool->request_free.back();
    pool->request_free.pop_back();
  } else {
    idx = static_cast<int32_t>(pool->requests.size());
    pool->requests.emplace_back();
  }
  Request& r = pool->requests[idx];
  r.pages.clear();
  r.offset = 0;
  r.live = true;
  return idx;
}

void pa_request_release(void* h, int32_t req) {
  Pool* pool = static_cast<Pool*>(h);
  Request& r = pool->requests[req];
  if (!r.live) return;
  for (int32_t p : r.pages) pool->free_page(p);
  r.pages.clear();
  r.offset = 0;
  r.live = false;
  pool->request_free.push_back(req);
}

// Ensure positions [0, new_offset) are backed. Returns the number of
// pages added, or -1 on pool exhaustion (already-added pages are kept so
// the caller can release the request to roll back).
int32_t pa_request_ensure(void* h, int32_t req, int32_t new_offset,
                          int32_t page_size) {
  Pool* pool = static_cast<Pool*>(h);
  Request& r = pool->requests[req];
  int32_t needed = (new_offset + page_size - 1) / page_size;
  int32_t added = 0;
  while (static_cast<int32_t>(r.pages.size()) < needed) {
    int32_t p = pool->alloc();
    if (p < 0) return -1;
    r.pages.push_back(p);
    ++added;
  }
  return added;
}

// Record n appended tokens; -1 (nothing recorded) past the ensured pages.
int32_t pa_request_advance(void* h, int32_t req, int32_t n, int32_t page_size) {
  Request& r = static_cast<Pool*>(h)->requests[req];
  if (static_cast<int64_t>(r.offset) + n > static_cast<int64_t>(r.pages.size()) * page_size)
    return -1;
  r.offset += n;
  return 0;
}

// Drop the newest n tokens, freeing whole trailing pages; -1 (nothing
// dropped) when n passes the offset.
int32_t pa_request_rewind(void* h, int32_t req, int32_t n, int32_t page_size) {
  Pool* pool = static_cast<Pool*>(h);
  Request& r = pool->requests[req];
  if (n > r.offset) return -1;
  r.offset -= n;
  int32_t needed = (r.offset + page_size - 1) / page_size;
  while (static_cast<int32_t>(r.pages.size()) > needed) {
    pool->free_page(r.pages.back());
    r.pages.pop_back();
  }
  return 0;
}

int32_t pa_request_offset(void* h, int32_t req) {
  return static_cast<Pool*>(h)->requests[req].offset;
}

int32_t pa_request_num_pages(void* h, int32_t req) {
  return static_cast<int32_t>(static_cast<Pool*>(h)->requests[req].pages.size());
}

// out[i] = request reqs[i]'s offset (0 where reqs[i] < 0, an idle slot).
void pa_fill_offsets(void* h, const int32_t* reqs, int32_t nreqs, int32_t* out) {
  Pool* pool = static_cast<Pool*>(h);
  for (int32_t i = 0; i < nreqs; ++i) out[i] = reqs[i] < 0 ? 0 : pool->requests[reqs[i]].offset;
}

// Fill out[nreqs * width] with page ids (-1 padded). reqs[i] < 0 marks an
// idle slot (all -1).
void pa_fill_block_table(void* h, const int32_t* reqs, int32_t nreqs,
                         int32_t width, int32_t* out) {
  Pool* pool = static_cast<Pool*>(h);
  for (int32_t i = 0; i < nreqs; ++i) {
    int32_t* row = out + static_cast<int64_t>(i) * width;
    if (reqs[i] < 0) {
      for (int32_t j = 0; j < width; ++j) row[j] = -1;
      continue;
    }
    const Request& r = pool->requests[reqs[i]];
    int32_t n = static_cast<int32_t>(r.pages.size());
    for (int32_t j = 0; j < width; ++j) row[j] = j < n ? r.pages[j] : -1;
  }
}

}  // extern "C"
