// Shared-memory blocking ring queue — the native transport of the runtime.
//
// Role in the framework: the reference moves 640x480x3 frames between its
// host and compute processes by pickling them through a TCP BaseManager
// queue (reference manager.py:6-15) and between module processes through
// multiprocessing.Queue pipes (reference main.py:26-38) — two copies + a
// serialization per hop. This implements the same capacity-N blocking
// queue contract as a POSIX shared-memory ring with process-shared
// pthread mutex/condvars: zero-copy within a host, microsecond-scale
// hand-off, no pickling. Python binds via ctypes (runtime/native/__init__.py).
//
// Contract (mirrors queue.Queue(maxsize)):
//   - push blocks while full (or times out), pop blocks while empty
//   - FIFO order, single payload buffer per slot with a length header
//   - robust to peer death mid-wait via timed waits

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  uint64_t magic;
  uint64_t slot_size;
  uint32_t n_slots;
  uint32_t head;  // next slot to pop
  uint32_t tail;  // next slot to push
  uint32_t count;
  pthread_mutex_t mutex;
  pthread_cond_t not_full;
  pthread_cond_t not_empty;
};

constexpr uint64_t kMagic = 0x49534246534152ULL;  // "ISBFSAR"

struct Handle {
  Header* hdr;
  uint8_t* slots;   // n_slots * (8-byte length + slot_size)
  size_t map_size;
  char name[256];
  bool owner;
};

inline uint8_t* slot_ptr(Handle* h, uint32_t idx) {
  return h->slots + static_cast<size_t>(idx) * (8 + h->hdr->slot_size);
}

void abs_deadline(timespec* ts, int timeout_ms) {
  clock_gettime(CLOCK_REALTIME, ts);
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += static_cast<long>(timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

}  // namespace

extern "C" {

void* shmq_create(const char* name, uint64_t slot_size, uint32_t n_slots) {
  size_t map_size = sizeof(Header) + static_cast<size_t>(n_slots) * (8 + slot_size);
  shm_unlink(name);  // stale segment from a dead process
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;

  Header* hdr = static_cast<Header*>(mem);
  hdr->slot_size = slot_size;
  hdr->n_slots = n_slots;
  hdr->head = hdr->tail = hdr->count = 0;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->mutex, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&hdr->not_full, &ca);
  pthread_cond_init(&hdr->not_empty, &ca);
  hdr->magic = kMagic;  // publish last

  Handle* h = new Handle();
  h->hdr = hdr;
  h->slots = static_cast<uint8_t*>(mem) + sizeof(Header);
  h->map_size = map_size;
  snprintf(h->name, sizeof(h->name), "%s", name);
  h->owner = true;
  return h;
}

void* shmq_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* hdr = static_cast<Header*>(mem);
  if (hdr->magic != kMagic) {
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  Handle* h = new Handle();
  h->hdr = hdr;
  h->slots = static_cast<uint8_t*>(mem) + sizeof(Header);
  h->map_size = static_cast<size_t>(st.st_size);
  snprintf(h->name, sizeof(h->name), "%s", name);
  h->owner = false;
  return h;
}

static int lock_robust(Header* hdr) {
  int rc = pthread_mutex_lock(&hdr->mutex);
  if (rc == EOWNERDEAD) {  // peer died holding the lock: recover
    pthread_mutex_consistent(&hdr->mutex);
    rc = 0;
  }
  return rc;
}

// Returns 0 on success, -1 timeout, -2 payload too large / bad handle.
int shmq_push(void* handle, const void* data, uint64_t len, int timeout_ms) {
  Handle* h = static_cast<Handle*>(handle);
  if (h == nullptr || len > h->hdr->slot_size) return -2;
  Header* hdr = h->hdr;
  timespec ts;
  abs_deadline(&ts, timeout_ms);
  if (lock_robust(hdr) != 0) return -2;
  while (hdr->count == hdr->n_slots) {
    int rc = pthread_cond_timedwait(&hdr->not_full, &hdr->mutex, &ts);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&hdr->mutex);
      return -1;
    }
  }
  uint8_t* slot = slot_ptr(h, hdr->tail);
  memcpy(slot, &len, 8);
  memcpy(slot + 8, data, len);
  hdr->tail = (hdr->tail + 1) % hdr->n_slots;
  hdr->count += 1;
  pthread_cond_signal(&hdr->not_empty);
  pthread_mutex_unlock(&hdr->mutex);
  return 0;
}

// Two-segment push (header + frame) without a host-side concatenation copy.
int shmq_push2(void* handle, const void* a, uint64_t alen,
               const void* b, uint64_t blen, int timeout_ms) {
  Handle* h = static_cast<Handle*>(handle);
  if (h == nullptr || alen + blen > h->hdr->slot_size) return -2;
  Header* hdr = h->hdr;
  timespec ts;
  abs_deadline(&ts, timeout_ms);
  if (lock_robust(hdr) != 0) return -2;
  while (hdr->count == hdr->n_slots) {
    int rc = pthread_cond_timedwait(&hdr->not_full, &hdr->mutex, &ts);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&hdr->mutex);
      return -1;
    }
  }
  uint8_t* slot = slot_ptr(h, hdr->tail);
  uint64_t len = alen + blen;
  memcpy(slot, &len, 8);
  memcpy(slot + 8, a, alen);
  if (blen) memcpy(slot + 8 + alen, b, blen);
  hdr->tail = (hdr->tail + 1) % hdr->n_slots;
  hdr->count += 1;
  pthread_cond_signal(&hdr->not_empty);
  pthread_mutex_unlock(&hdr->mutex);
  return 0;
}

// Returns payload length on success, -1 timeout, -2 buffer too small / bad handle.
int64_t shmq_pop(void* handle, void* out, uint64_t cap, int timeout_ms) {
  Handle* h = static_cast<Handle*>(handle);
  if (h == nullptr) return -2;
  Header* hdr = h->hdr;
  timespec ts;
  abs_deadline(&ts, timeout_ms);
  if (lock_robust(hdr) != 0) return -2;
  while (hdr->count == 0) {
    int rc = pthread_cond_timedwait(&hdr->not_empty, &hdr->mutex, &ts);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&hdr->mutex);
      return -1;
    }
  }
  uint8_t* slot = slot_ptr(h, hdr->head);
  uint64_t len;
  memcpy(&len, slot, 8);
  if (len > cap) {
    pthread_mutex_unlock(&hdr->mutex);
    return -2;
  }
  memcpy(out, slot + 8, len);
  hdr->head = (hdr->head + 1) % hdr->n_slots;
  hdr->count -= 1;
  pthread_cond_signal(&hdr->not_full);
  pthread_mutex_unlock(&hdr->mutex);
  return static_cast<int64_t>(len);
}

// The segment's actual slot size — openers use it to validate that the
// geometry they expect (frame shape, pickle budget) matches what the
// creator built, instead of failing later with an opaque push/reshape error.
uint64_t shmq_slot_size(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h || !h->hdr) return 0;
  return h->hdr->slot_size;
}

uint32_t shmq_size(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  return h != nullptr ? h->hdr->count : 0;
}

void shmq_close(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  if (h == nullptr) return;
  bool owner = h->owner;
  char name[256];
  memcpy(name, h->name, sizeof(name));
  munmap(h->hdr, h->map_size);
  if (owner) shm_unlink(name);
  delete h;
}

}  // extern "C"
