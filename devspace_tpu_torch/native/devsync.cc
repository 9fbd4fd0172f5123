// libdevsync — native fast path for the sync engine's local filesystem scans.
//
// The reference implementation (hoatle/devspace, pkg/devspace/sync) is a Go
// binary whose local walks are compiled code; this library keeps the
// Python framework's hot loops (initial-sync snapshot, downstream compare,
// build-context hashing — SURVEY §2.2/§2.5) at native speed. The Python
// side (devspace_tpu_torch/utils/native.py) builds it with g++ at first use
// into the package's _build/, loads it via ctypes and falls back to pure
// Python when the library is absent.
//
// The port's own copy of the JAX package's native/devsync.cc, with the same
// C ABI (ds_walk, ds_pack, ds_free, ds_abi_version = 2) and the same code.
//
// C ABI, one call: ds_walk(root, prune_csv, follow_symlinks) returns a
// malloc'd NUL-terminated buffer of lines
//   relpath\tsize\tmtime_sec\tmtime_ns\trawmode_oct\tuid\tgid\tis_symlink\n
// (relpath '/'-separated; rawmode octal st_mode incl. file type bits, so
// the Python layer derives is_dir like parse_stat_line does).
// prune_csv: comma-separated directory *names* to skip entirely (fast-path
// for excludes like .git, node_modules; full gitignore semantics stay in
// Python). Free with ds_free.

#include <dirent.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/stat.h>
#include <sys/types.h>

#include <set>
#include <string>
#include <utility>
#include <vector>

namespace {

struct Output {
  char* buf = nullptr;
  size_t len = 0;
  size_t cap = 0;

  void ensure(size_t extra) {
    if (len + extra + 1 <= cap) return;
    size_t want = (cap ? cap * 2 : 1 << 16);
    while (want < len + extra + 1) want *= 2;
    buf = static_cast<char*>(realloc(buf, want));
    cap = want;
  }

  void append_line(const std::string& rel, const struct stat& st,
                   bool is_symlink) {
    // The symlink flag rides as its own column: a followed symlink-to-dir
    // is both a directory (stat) and a link (lstat), and the exclusive
    // file-type bits of st_mode cannot express that.
    char meta[160];
    int n = snprintf(meta, sizeof meta,
                     "\t%lld\t%lld\t%lld\t%o\t%u\t%u\t%d\n",
                     S_ISDIR(st.st_mode) ? 0LL
                                         : static_cast<long long>(st.st_size),
                     static_cast<long long>(st.st_mtim.tv_sec),
                     static_cast<long long>(st.st_mtim.tv_nsec),
                     static_cast<unsigned>(st.st_mode),
                     static_cast<unsigned>(st.st_uid),
                     static_cast<unsigned>(st.st_gid), is_symlink ? 1 : 0);
    ensure(rel.size() + static_cast<size_t>(n));
    memcpy(buf + len, rel.data(), rel.size());
    len += rel.size();
    memcpy(buf + len, meta, static_cast<size_t>(n));
    len += static_cast<size_t>(n);
  }
};

bool pruned(const std::vector<std::string>& prune, const char* name) {
  for (const auto& p : prune)
    if (p == name) return true;
  return false;
}

// --- tar assembly (ds_pack) -------------------------------------------------
// The initial-sync upstream batch packs thousands of small files; CPython's
// tarfile spends ~70us per member on TarInfo/header bookkeeping, an order
// of magnitude over the actual I/O (the JAX package's docs/PERF.md). The packer
// emits an UNCOMPRESSED GNU-format tar — gzip stays in Python (zlib is C
// already), and the format matches what tarfile reads on the remote side.

void raw_append(Output& out, const char* data, size_t n) {
  out.ensure(n);
  memcpy(out.buf + out.len, data, n);
  out.len += n;
}

// Does ``value`` fit a ``len``-byte octal header field (len-1 digits)?
// Overflow must abort the whole pack (caller falls back to Python's PAX
// writer) — a truncated size field would silently misalign every
// following member.
bool fits_octal(unsigned long long value, size_t len) {
  unsigned long long limit = 1;
  for (size_t i = 0; i + 1 < len; i++) limit *= 8;
  return value < limit;
}

void pack_octal(char* field, size_t len, unsigned long long value) {
  // via scratch: silences -Wformat-truncation (callers pre-check with
  // fits_octal; this is belt-and-suspenders)
  char tmp[32];
  int n = snprintf(tmp, sizeof tmp, "%0*llo", static_cast<int>(len - 1), value);
  memcpy(field, tmp, static_cast<size_t>(n) < len ? n + 1 : len);
}

void tar_header(Output& out, const std::string& name, unsigned long long mode,
                unsigned long long uid, unsigned long long gid,
                unsigned long long size, unsigned long long mtime,
                char typeflag) {
  char hdr[512];
  memset(hdr, 0, sizeof hdr);
  size_t nlen = name.size();
  memcpy(hdr, name.data(), nlen < 100 ? nlen : 100);
  pack_octal(hdr + 100, 8, mode);
  pack_octal(hdr + 108, 8, uid);
  pack_octal(hdr + 116, 8, gid);
  pack_octal(hdr + 124, 12, size);
  pack_octal(hdr + 136, 12, mtime);
  memset(hdr + 148, ' ', 8);  // checksum computed over spaces
  hdr[156] = typeflag;
  memcpy(hdr + 257, "ustar  ", 8);  // GNU magic+version ("ustar  \0")
  unsigned sum = 0;
  for (size_t i = 0; i < sizeof hdr; i++) sum += static_cast<unsigned char>(hdr[i]);
  char chk[16];
  snprintf(chk, sizeof chk, "%06o", sum);
  memcpy(hdr + 148, chk, 7);  // "dddddd\0"
  hdr[155] = ' ';  // canonical terminator: NUL then space
  raw_append(out, hdr, sizeof hdr);
}

void tar_pad(Output& out, size_t written) {
  static const char zeros[512] = {0};
  size_t rem = written % 512;
  if (rem) raw_append(out, zeros, 512 - rem);
}

// GNU @LongLink extension for member names that don't fit the 100-byte
// header field (what tarfile's GNU writer emits; its reader consumes it).
void tar_name(Output& out, const std::string& name, unsigned long long mtime) {
  if (name.size() < 100) return;
  tar_header(out, "././@LongLink", 0644, 0, 0, name.size() + 1, mtime, 'L');
  raw_append(out, name.c_str(), name.size() + 1);
  tar_pad(out, name.size() + 1);
}

}  // namespace

extern "C" {

// ABI version so the Python loader can refuse a stale build.
uint64_t ds_abi_version() { return 2; }

// Pack local files into an uncompressed GNU tar. ``entries`` is
// newline-separated records ``relpath\tis_dir\tmode\tuid\tgid\tmtime``
// (mode/uid/gid decimal, -1 = "use/derive the local default": files take
// st_mode&07777 and uid/gid 0 — exactly the Python packer's TarInfo
// defaults in sync/shell.py build_tar; dirs take 0755). Entries whose
// stat/open fails are skipped (raced concurrent delete, same as the
// Python path). Returns a malloc'd buffer (*out_len bytes; free with
// ds_free), or null on allocation/argument failure.
char* ds_pack(const char* root, const char* entries, uint64_t* out_len) {
  if (!root || !entries || !out_len) return nullptr;
  Output out;
  const char* p = entries;
  std::string root_s(root);
  if (!root_s.empty() && root_s.back() != '/') root_s += '/';
  std::vector<char> iobuf(1 << 16);
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t linelen = nl ? static_cast<size_t>(nl - p) : strlen(p);
    std::string line(p, linelen);
    p += linelen + (nl ? 1 : 0);
    // split 6 tab fields
    std::vector<std::string> f;
    size_t start = 0;
    for (size_t i = 0; i <= line.size(); i++) {
      if (i == line.size() || line[i] == '\t') {
        f.emplace_back(line, start, i - start);
        start = i + 1;
      }
    }
    if (f.size() != 6 || f[0].empty()) continue;
    const std::string& name = f[0];
    bool is_dir = f[1] == "1";
    long long mode = atoll(f[2].c_str());
    long long uid = atoll(f[3].c_str());
    long long gid = atoll(f[4].c_str());
    long long mtime = atoll(f[5].c_str());
    // any value the fixed octal fields can't carry (>=8GiB files,
    // uid/gid > 2097151, pre-1970 or far-future mtimes) aborts the
    // native pack — Python's PAX writer handles those fine
    if (mtime < 0 || !fits_octal(static_cast<unsigned long long>(mtime), 12) ||
        (uid >= 0 && !fits_octal(static_cast<unsigned long long>(uid), 8)) ||
        (gid >= 0 && !fits_octal(static_cast<unsigned long long>(gid), 8)) ||
        (mode >= 0 && !fits_octal(static_cast<unsigned long long>(mode), 8))) {
      free(out.buf);
      return nullptr;
    }
    if (is_dir) {
      std::string dname = name + "/";
      tar_name(out, dname, static_cast<unsigned long long>(mtime));
      tar_header(out, dname,
                 static_cast<unsigned long long>(mode >= 0 ? mode : 0755),
                 static_cast<unsigned long long>(uid >= 0 ? uid : 0),
                 static_cast<unsigned long long>(gid >= 0 ? gid : 0), 0,
                 static_cast<unsigned long long>(mtime), '5');
      continue;
    }
    std::string abs = root_s + name;
    struct stat st;
    if (stat(abs.c_str(), &st) != 0 || !S_ISREG(st.st_mode)) continue;
    unsigned long long size = static_cast<unsigned long long>(st.st_size);
    if (!fits_octal(size, 12) || st.st_mtim.tv_sec < 0 ||
        !fits_octal(static_cast<unsigned long long>(st.st_mtim.tv_sec), 12)) {
      free(out.buf);
      return nullptr;
    }
    FILE* fh = fopen(abs.c_str(), "rb");
    if (!fh) continue;
    tar_name(out, name, static_cast<unsigned long long>(st.st_mtim.tv_sec));
    tar_header(out, name,
               static_cast<unsigned long long>(
                   mode >= 0 ? mode : (st.st_mode & 07777)),
               static_cast<unsigned long long>(uid >= 0 ? uid : 0),
               static_cast<unsigned long long>(gid >= 0 ? gid : 0), size,
               static_cast<unsigned long long>(st.st_mtim.tv_sec), '0');
    unsigned long long copied = 0;
    while (copied < size) {
      size_t want = iobuf.size();
      if (size - copied < want) want = static_cast<size_t>(size - copied);
      size_t got = fread(iobuf.data(), 1, want, fh);
      if (got == 0) break;  // shrank underneath us: zero-fill the promise
      raw_append(out, iobuf.data(), got);
      copied += got;
    }
    fclose(fh);
    if (copied < size) {
      // header promised `size` bytes — keep the stream well-formed
      static const char zeros[512] = {0};
      while (copied < size) {
        unsigned long long want = size - copied;
        if (want > sizeof zeros) want = sizeof zeros;
        raw_append(out, zeros, static_cast<size_t>(want));
        copied += want;
      }
    }
    tar_pad(out, static_cast<size_t>(size));
  }
  // end-of-archive: two zero blocks
  static const char zeros[1024] = {0};
  raw_append(out, zeros, sizeof zeros);
  out.ensure(0);
  out.buf[out.len] = 0;
  *out_len = out.len;
  return out.buf;
}

char* ds_walk(const char* root, const char* prune_csv, int follow_symlinks) {
  std::vector<std::string> prune;
  if (prune_csv && *prune_csv) {
    const char* p = prune_csv;
    while (*p) {
      const char* comma = strchr(p, ',');
      size_t n = comma ? static_cast<size_t>(comma - p) : strlen(p);
      if (n) prune.emplace_back(p, n);
      p += n + (comma ? 1 : 0);
    }
  }

  Output out;
  // (dev, ino) of visited directories — symlink cycle guard, mirrors
  // walk_local_tree's seen_dirs set.
  std::set<std::pair<uint64_t, uint64_t>> seen;
  // stack of (abs_path, rel_path)
  std::vector<std::pair<std::string, std::string>> stack;
  stack.emplace_back(root, "");

  while (!stack.empty()) {
    auto [dir, rel_dir] = std::move(stack.back());
    stack.pop_back();

    DIR* d = opendir(dir.c_str());
    if (!d) continue;
    struct dirent* ent;
    while ((ent = readdir(d)) != nullptr) {
      const char* name = ent->d_name;
      if (name[0] == '.' && (name[1] == 0 || (name[1] == '.' && name[2] == 0)))
        continue;
      std::string abs = dir;
      if (abs.empty() || abs.back() != '/') abs += '/';
      abs += name;
      std::string rel = rel_dir.empty() ? name : rel_dir + "/" + name;

      struct stat lst;
      if (lstat(abs.c_str(), &lst) != 0) continue;
      bool is_symlink = S_ISLNK(lst.st_mode);
      struct stat st = lst;
      if (is_symlink && follow_symlinks) {
        if (stat(abs.c_str(), &st) != 0) continue;  // dangling link
      }

      if (S_ISDIR(st.st_mode)) {
        if (pruned(prune, name)) continue;
        out.append_line(rel, st, is_symlink);
        auto key = std::make_pair(static_cast<uint64_t>(st.st_dev),
                                  static_cast<uint64_t>(st.st_ino));
        if (seen.insert(key).second) stack.emplace_back(abs, rel);
      } else {
        out.append_line(rel, st, is_symlink);
      }
    }
    closedir(d);
  }

  out.ensure(0);
  out.buf[out.len] = 0;
  return out.buf;
}

void ds_free(char* p) { free(p); }

}  // extern "C"
