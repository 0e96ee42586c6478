// Threaded prefetch loader: the native data-loading runtime feeding the
// device batcher (the role pydub/ffmpeg + python loops play host-side in the
// reference — SURVEY.md §2.4).  Worker threads decode + mixdown + resample;
// results are delivered in submission order through a bounded queue.

#include "ovt_audio.h"

#include <condition_variable>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Clip {
  int64_t ticket;
  float* data = nullptr;  // malloc'd mono float32
  int64_t n = 0;
  bool error = false;
};

bool ends_with(const std::string& s, const char* suf) {
  size_t l = std::strlen(suf);
  if (s.size() < l) return false;
  for (size_t i = 0; i < l; i++) {
    char a = s[s.size() - l + i];
    if (a >= 'A' && a <= 'Z') a += 32;
    if (a != suf[i]) return false;
  }
  return true;
}

}  // namespace

struct OvtLoader {
  int target_sr;
  size_t capacity;

  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::deque<std::pair<int64_t, std::string>> work;
  std::map<int64_t, Clip> done;
  int64_t next_ticket = 0;
  int64_t next_deliver = 0;
  bool closing = false;
  std::vector<std::thread> threads;

  void worker() {
    for (;;) {
      std::pair<int64_t, std::string> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return closing || !work.empty(); });
        if (work.empty()) return;  // closing and drained
        job = work.front();
        work.pop_front();
      }
      Clip clip;
      clip.ticket = job.first;
      float* raw = nullptr;
      int sr = 0, ch = 0;
      int64_t frames;
      if (ends_with(job.second, ".mp3"))
        frames = ovt_mp3_decode(job.second.c_str(), &raw, &sr, &ch);
      else
        frames = ovt_wav_read(job.second.c_str(), &raw, &sr, &ch);
      if (frames < 0) {
        clip.error = true;
      } else {
        // mono mixdown
        float* mono = static_cast<float*>(std::malloc(frames * sizeof(float)));
        if (ch == 1) {
          std::memcpy(mono, raw, frames * sizeof(float));
        } else {
          for (int64_t i = 0; i < frames; i++) {
            double acc = 0;
            for (int c = 0; c < ch; c++) acc += raw[i * ch + c];
            mono[i] = float(acc / ch);
          }
        }
        std::free(raw);
        if (sr != target_sr) {
          float* res = nullptr;
          int64_t m = ovt_resample(mono, frames, sr, target_sr, &res);
          std::free(mono);
          if (m < 0) {
            clip.error = true;
          } else {
            clip.data = res;
            clip.n = m;
          }
        } else {
          clip.data = mono;
          clip.n = frames;
        }
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_done.wait(lk, [&] { return closing || done.size() < capacity; });
        done[clip.ticket] = clip;
      }
      cv_done.notify_all();
    }
  }
};

extern "C" OvtLoader* ovt_loader_create(int n_threads, int target_sr,
                                        int queue_capacity) {
  auto* l = new OvtLoader();
  l->target_sr = target_sr;
  l->capacity = queue_capacity > 0 ? queue_capacity : 16;
  for (int i = 0; i < (n_threads > 0 ? n_threads : 2); i++)
    l->threads.emplace_back([l] { l->worker(); });
  return l;
}

extern "C" void ovt_loader_destroy(OvtLoader* l) {
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->closing = true;
  }
  l->cv_work.notify_all();
  l->cv_done.notify_all();
  for (auto& t : l->threads) t.join();
  for (auto& kv : l->done)
    if (kv.second.data) std::free(kv.second.data);
  delete l;
}

extern "C" int64_t ovt_loader_submit(OvtLoader* l, const char* path) {
  std::lock_guard<std::mutex> lk(l->mu);
  if (l->closing) return -1;
  int64_t t = l->next_ticket++;
  l->work.emplace_back(t, std::string(path));
  l->cv_work.notify_one();
  return t;
}

extern "C" int64_t ovt_loader_next(OvtLoader* l, float** out, int64_t* n,
                                   int64_t* ticket) {
  std::unique_lock<std::mutex> lk(l->mu);
  int64_t want = l->next_deliver;
  if (want >= l->next_ticket) return -1;  // nothing pending
  l->cv_done.wait(lk, [&] { return l->done.count(want) > 0; });
  Clip clip = l->done[want];
  l->done.erase(want);
  l->next_deliver++;
  lk.unlock();
  l->cv_done.notify_all();
  *ticket = clip.ticket;
  if (clip.error) return -2;
  *out = clip.data;
  *n = clip.n;
  return clip.ticket;
}

extern "C" void ovt_free(void* ptr) { std::free(ptr); }
