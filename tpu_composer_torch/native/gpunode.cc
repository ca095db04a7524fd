// gpunode — native node-agent core of the PyTorch port (a copy of the
// JAX package's native/tpunode.cc whose enumeration also matches NVIDIA
// GPU device nodes).
//
// The node agent links this small C++ library for the hot, syscall-heavy
// paths that run on every reconcile poll:
//   - per-chip device enumeration (/dev/accel* on a TPU host, the per-GPU
//     /dev/nvidia<minor> nodes on an NVIDIA host),
//   - open-fd holder scanning across /proc (the drain guard),
//   - sysfs/procfs reads, and the inotify watch on /dev.
// Exposed with a plain C ABI consumed through ctypes
// (tpu_composer_torch/agent/native.py), which builds it with the host C++
// compiler at first use; the agent's pure-Python paths have the same
// semantics and are the reference the tests hold this library against.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dirent.h>
#include <poll.h>
#include <string>
#include <sys/inotify.h>
#include <sys/types.h>
#include <unistd.h>
#include <vector>
#include <algorithm>

namespace {

bool starts_with(const char* s, const char* prefix) {
  return std::strncmp(s, prefix, std::strlen(prefix)) == 0;
}

bool all_digits(const char* s) {
  if (!*s) return false;
  for (; *s; ++s)
    if (*s < '0' || *s > '9') return false;
  return true;
}

// A per-chip device node: accel*, or a per-GPU nvidia<minor>. NVIDIA's
// control nodes (nvidiactl, nvidia-uvm, nvidia-uvm-tools, nvidia-modeset)
// and the nvidia-caps directory never match.
bool per_chip_node(const char* name) {
  if (starts_with(name, "accel")) return true;
  return starts_with(name, "nvidia") && all_digits(name + 6);
}

}  // namespace

extern "C" {

const char* tpun_version() { return "gpunode 0.1.0"; }

// Enumerate per-chip device nodes (per_chip_node) under dev_dir. Writes newline-separated
// absolute paths into buf (NUL-terminated); returns the number of devices
// found, or -1 if the buffer is too small, or 0 when dev_dir is absent.
int tpun_enum_accel(const char* dev_dir, char* buf, int buflen) {
  DIR* d = opendir(dev_dir);
  if (!d) {
    if (buflen > 0) buf[0] = '\0';
    return 0;
  }
  std::vector<std::string> found;
  struct dirent* e;
  while ((e = readdir(d)) != nullptr) {
    if (per_chip_node(e->d_name))
      found.push_back(std::string(dev_dir) + "/" + e->d_name);
  }
  closedir(d);
  std::sort(found.begin(), found.end());
  std::string joined;
  for (const auto& p : found) {
    if (!joined.empty()) joined += '\n';
    joined += p;
  }
  if ((int)joined.size() + 1 > buflen) return -1;
  std::memcpy(buf, joined.c_str(), joined.size() + 1);
  return (int)found.size();
}

// Scan proc_dir for processes with an open fd resolving to dev_path.
// Fills up to max_pids entries; returns the holder count (which may exceed
// max_pids), or -1 on error.
int tpun_fd_holders(const char* dev_path, const char* proc_dir, int* pids,
                    int max_pids) {
  DIR* proc = opendir(proc_dir);
  if (!proc) return -1;
  int count = 0;
  struct dirent* pe;
  char fd_dir[512], link_path[768], target[768];
  while ((pe = readdir(proc)) != nullptr) {
    if (!all_digits(pe->d_name)) continue;
    std::snprintf(fd_dir, sizeof fd_dir, "%s/%s/fd", proc_dir, pe->d_name);
    DIR* fds = opendir(fd_dir);
    if (!fds) continue;  // permission or exited — same as the Python fallback
    struct dirent* fe;
    while ((fe = readdir(fds)) != nullptr) {
      if (fe->d_name[0] == '.') continue;
      std::snprintf(link_path, sizeof link_path, "%s/%s", fd_dir, fe->d_name);
      ssize_t n = readlink(link_path, target, sizeof target - 1);
      if (n <= 0) continue;
      target[n] = '\0';
      if (std::strcmp(target, dev_path) == 0) {
        if (count < max_pids) pids[count] = std::atoi(pe->d_name);
        ++count;
        break;  // one hit per process is enough
      }
    }
    closedir(fds);
  }
  closedir(proc);
  return count;
}

// Read a small sysfs/procfs file into buf; returns bytes read or -1.
int tpun_read_file(const char* path, char* buf, int buflen) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  size_t n = std::fread(buf, 1, (size_t)(buflen > 0 ? buflen - 1 : 0), f);
  std::fclose(f);
  buf[n] = '\0';
  return (int)n;
}

// Scan proc_dir ONCE for processes holding any of the newline-separated
// dev_paths open. A 4-chip group drain needs the holder sets of 4 device
// nodes; the per-path scan costs 4 full /proc sweeps (and the reference's
// exec'd `ls -l /proc/*/fd` pipeline costs a process spawn per check,
// gpus.go:416-439) where one sweep has all the answers. Writes
// (pid, path_index) pairs into `pairs` (2 ints per hit, up to max_pairs
// pairs) and returns the total hit count — which may exceed max_pairs, in
// which case the overflow hits are counted but not recorded — or -1 on
// error (callers must treat error as UNKNOWN, never as idle: this guards
// drains).
int tpun_fd_holders_multi(const char* dev_paths, const char* proc_dir,
                          int* pairs, int max_pairs) {
  std::vector<std::string> paths;
  {
    const char* start = dev_paths;
    for (const char* p = dev_paths;; ++p) {
      if (*p == '\n' || *p == '\0') {
        if (p > start) paths.emplace_back(start, p - start);
        if (*p == '\0') break;
        start = p + 1;
      }
    }
  }

  DIR* proc = opendir(proc_dir);
  if (!proc) return -1;
  int total = 0;
  struct dirent* pe;
  char fd_dir[512], link_path[768], target[768];
  while ((pe = readdir(proc)) != nullptr) {
    if (!all_digits(pe->d_name)) continue;
    std::snprintf(fd_dir, sizeof fd_dir, "%s/%s/fd", proc_dir, pe->d_name);
    DIR* fds = opendir(fd_dir);
    if (!fds) continue;  // permission or exited — same as the Python fallback
    std::vector<bool> hit(paths.size(), false);
    struct dirent* fe;
    while ((fe = readdir(fds)) != nullptr) {
      if (fe->d_name[0] == '.') continue;
      std::snprintf(link_path, sizeof link_path, "%s/%s", fd_dir, fe->d_name);
      ssize_t n = readlink(link_path, target, sizeof target - 1);
      if (n <= 0) continue;
      target[n] = '\0';
      for (size_t i = 0; i < paths.size(); ++i) {
        if (!hit[i] && paths[i] == target) {
          hit[i] = true;
          if (total < max_pairs) {
            pairs[2 * total] = std::atoi(pe->d_name);
            pairs[2 * total + 1] = (int)i;
          }
          ++total;
        }
      }
    }
    closedir(fds);
  }
  closedir(proc);
  return total;
}

// Read the short command name of a pid (proc_dir/<pid>/comm, trailing
// newline stripped) into buf; returns its length or -1. Lets drain-refusal
// diagnostics name the offending workload, as the reference's
// `nvidia-smi --query-compute-apps=pid,process_name` output does
// (gpus.go:241-350).
int tpun_proc_name(const char* proc_dir, int pid, char* buf, int buflen) {
  char path[512];
  std::snprintf(path, sizeof path, "%s/%d/comm", proc_dir, pid);
  int n = tpun_read_file(path, buf, buflen);
  if (n <= 0) return n;
  while (n > 0 && (buf[n - 1] == '\n' || buf[n - 1] == '\r')) buf[--n] = '\0';
  return n;
}

// Block until something is created/deleted/moved under dev_dir (inotify) or
// timeout_ms elapses. Returns 1 on an event, 0 on timeout, -1 on error.
// This is the event-driven alternative to the visibility poll: instead of
// re-enumerating /dev on a fixed cadence (the reference's 30s requeue,
// composableresource_controller.go:298), the node agent sleeps here and the
// controller is nudged the instant the fabric materializes the device node.
int tpun_watch_dev(const char* dev_dir, int timeout_ms) {
  int fd = inotify_init1(IN_NONBLOCK);
  if (fd < 0) return -1;
  int wd = inotify_add_watch(
      fd, dev_dir, IN_CREATE | IN_DELETE | IN_MOVED_TO | IN_MOVED_FROM | IN_ATTRIB);
  if (wd < 0) {
    close(fd);
    return -1;
  }
  struct pollfd pfd = {fd, POLLIN, 0};
  int rc = poll(&pfd, 1, timeout_ms);
  int result = 0;
  if (rc < 0) {
    result = -1;
  } else if (rc > 0 && (pfd.revents & POLLIN)) {
    char evbuf[4096];
    result = read(fd, evbuf, sizeof evbuf) > 0 ? 1 : -1;
  }
  inotify_rm_watch(fd, wd);
  close(fd);
  return result;
}

}  // extern "C"
