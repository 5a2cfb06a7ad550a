// Opaque-handle RAII plumbing for the dlimgedit_tpu public C++ API.
//
// Global function-table access with lazy auto-init when linked against the
// library, plus a move-only Handle<T> that releases through the table.

#pragma once

#include <dlimgedit/detail/dlimgedit.h>

#include <utility>

namespace dlimg {
namespace detail {

inline dlimg_Api const*& api_ptr() {
    static dlimg_Api const* ptr = nullptr;
    return ptr;
}

inline void set_api(dlimg_Api const* api) { api_ptr() = api; }

inline dlimg_Api const& api() {
#ifndef DLIMGEDIT_LOAD_DYNAMIC
    if (!api_ptr()) {
        api_ptr() = dlimg_init();
    }
#endif
    return *api_ptr();
}

template <typename T> void destroy_handle(T* handle);

template <> inline void destroy_handle(dlimg_Environment_* h) {
    api().destroy_environment(h);
}
template <> inline void destroy_handle(dlimg_Segmentation_* h) {
    api().destroy_segmentation(h);
}

} // namespace detail

// Move-only owner of an opaque runtime handle.
template <typename T> class Handle {
  public:
    Handle() noexcept = default;
    explicit Handle(T* h) noexcept : handle_(h) {}

    T* handle() const noexcept { return handle_; }
    explicit operator bool() const noexcept { return handle_ != nullptr; }

    ~Handle() { reset(); }
    Handle(Handle&& other) noexcept : handle_(other.handle_) {
        other.handle_ = nullptr;
    }
    Handle& operator=(Handle&& other) noexcept {
        std::swap(handle_, other.handle_);
        return *this;
    }
    Handle(Handle const&) = delete;
    Handle& operator=(Handle const&) = delete;

  protected:
    // Destination slot for C factory functions.
    T*& emplace() noexcept {
        reset();
        return handle_;
    }

  private:
    void reset() noexcept {
        if (handle_) {
            detail::destroy_handle(handle_);
            handle_ = nullptr;
        }
    }

    T* handle_ = nullptr;
};

} // namespace dlimg
