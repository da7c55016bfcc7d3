// Native draw sink: high-throughput append-only storage for kept draws.
//
// The reference keeps every draw in a resident matrix sized up front
// (reference src/rwmh.cpp:105 BMO_MATOPS_SET_SIZE(draws_out, ...)) — fine in
// one C++ process, wrong for a host that streams millions of draws per
// second off the card. This sink double-buffers host-side chunks and writes
// them to disk on a background thread, so device->host transfer and disk IO
// overlap with sampling. File layout: 64-byte header (magic, dtype, ndim,
// shape of one draw row-block) followed by raw row-major chunks; readable
// zero-copy via numpy memmap.
//
// Exposed as a C ABI for ctypes. The JAX package's sink
// (mcmc_tpu/runtime/drawsink.cpp) writes the same format, byte for byte.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Header {
    char magic[8];        // "MCMCSINK"
    uint32_t version;
    uint32_t dtype_code;  // 0 = f32, 1 = f64
    uint32_t ndim;        // dims of one appended block's trailing shape
    uint32_t reserved;
    uint64_t dims[4];     // trailing shape (without the leading draw axis)
    uint64_t n_rows;      // total leading-axis rows appended (updated on close)
};
static_assert(sizeof(Header) <= 96, "header fits");

class DrawSink {
  public:
    DrawSink(const char* path, uint32_t dtype_code, uint32_t ndim,
             const uint64_t* dims)
        : path_(path), stop_(false), error_(false), n_rows_(0) {
        f_ = std::fopen(path, "wb");
        if (!f_) { error_ = true; return; }
        std::memset(&hdr_, 0, sizeof(hdr_));
        std::memcpy(hdr_.magic, "MCMCSINK", 8);
        hdr_.version = 1;
        hdr_.dtype_code = dtype_code;
        hdr_.ndim = ndim;
        for (uint32_t i = 0; i < ndim && i < 4; ++i) hdr_.dims[i] = dims[i];
        std::fwrite(&hdr_, sizeof(hdr_), 1, f_);
        worker_ = std::thread([this] { this->run(); });
    }

    ~DrawSink() { close(); }

    // Enqueue a copy of `data` (n_rows leading rows). Returns 0 on success.
    int append(const void* data, uint64_t n_rows, uint64_t n_bytes) {
        if (error_) return 1;
        std::vector<char> buf((const char*)data, (const char*)data + n_bytes);
        {
            std::unique_lock<std::mutex> lk(mu_);
            // bounded queue: cap pending chunks so memory stays bounded
            cv_space_.wait(lk, [this] { return queue_.size() < 8 || stop_; });
            if (stop_) return 1;
            queue_.emplace_back(std::move(buf));
            pending_rows_.push_back(n_rows);
        }
        cv_data_.notify_one();
        return 0;
    }

    // Block until everything queued so far reaches the OS. A chunk the
    // worker has popped but not yet fwritten counts as pending (writing_),
    // so callers may mark draws durable once this returns.
    void flush() {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [this] { return queue_.empty() && !writing_; });
        if (f_) std::fflush(f_);
    }

    void close() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            if (stop_) return;
            cv_space_.wait(lk, [this] { return queue_.empty() && !writing_; });
            stop_ = true;
        }
        cv_data_.notify_all();
        if (worker_.joinable()) worker_.join();
        if (f_) {
            hdr_.n_rows = n_rows_.load();
            std::fseek(f_, 0, SEEK_SET);
            std::fwrite(&hdr_, sizeof(hdr_), 1, f_);
            std::fclose(f_);
            f_ = nullptr;
        }
    }

    uint64_t rows() const { return n_rows_.load(); }
    bool ok() const { return !error_; }

  private:
    void run() {
        for (;;) {
            std::vector<char> buf;
            uint64_t rows = 0;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_data_.wait(lk, [this] { return !queue_.empty() || stop_; });
                if (queue_.empty() && stop_) return;
                buf = std::move(queue_.front());
                queue_.pop_front();
                rows = pending_rows_.front();
                pending_rows_.pop_front();
                writing_ = true;
            }
            if (std::fwrite(buf.data(), 1, buf.size(), f_) != buf.size()) {
                error_ = true;
            }
            n_rows_ += rows;
            {
                std::lock_guard<std::mutex> lk(mu_);
                writing_ = false;
            }
            cv_space_.notify_all();
        }
    }

    std::string path_;
    std::FILE* f_ = nullptr;
    Header hdr_;
    std::thread worker_;
    std::mutex mu_;
    std::condition_variable cv_data_, cv_space_;
    std::deque<std::vector<char>> queue_;
    std::deque<uint64_t> pending_rows_;
    bool writing_ = false;  // guarded by mu_: a popped chunk is mid-fwrite
    std::atomic<bool> stop_;
    std::atomic<bool> error_;
    std::atomic<uint64_t> n_rows_;
};

}  // namespace

extern "C" {

void* drawsink_open(const char* path, uint32_t dtype_code, uint32_t ndim,
                    const uint64_t* dims) {
    auto* s = new DrawSink(path, dtype_code, ndim, dims);
    if (!s->ok()) { delete s; return nullptr; }
    return s;
}

int drawsink_append(void* sink, const void* data, uint64_t n_rows,
                    uint64_t n_bytes) {
    return static_cast<DrawSink*>(sink)->append(data, n_rows, n_bytes);
}

void drawsink_flush(void* sink) { static_cast<DrawSink*>(sink)->flush(); }

uint64_t drawsink_rows(void* sink) { return static_cast<DrawSink*>(sink)->rows(); }

void drawsink_close(void* sink) {
    auto* s = static_cast<DrawSink*>(sink);
    s->close();
    delete s;
}

}  // extern "C"
