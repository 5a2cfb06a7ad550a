/* dlimgedit_tpu C ABI — binary-compatible with the dlimgedit 1.x function
 * table so existing clients of the reference library can switch runtimes by
 * swapping the shared object. The implementation (native/src/capi.cpp)
 * drives the JAX/XLA TPU runtime instead of ONNX Runtime.
 *
 * ABI contract mirrored from dlimgedit (see SURVEY.md §1 L5): a single
 * exported symbol `dlimg_init` returning a function table; opaque handles;
 * error codes + `last_error` string for all fallible entries.
 */
#ifndef DLIMGEDIT_TPU_CAPI_H_
#define DLIMGEDIT_TPU_CAPI_H_

#if defined(DLIMGEDIT_EXPORTS)
#    if defined(_MSC_VER)
#        define DLIMG_API __declspec(dllexport)
#    else
#        define DLIMG_API __attribute__((visibility("default")))
#    endif
#else
#    if defined(_MSC_VER)
#        define DLIMG_API __declspec(dllimport)
#    else
#        define DLIMG_API
#    endif
#endif

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Opaque handles owned by the runtime. */
typedef struct dlimg_Environment_* dlimg_Environment;
typedef struct dlimg_Segmentation_* dlimg_Segmentation;

/* Non-owning view of packed row-major uint8 pixels.
 * channels: 1=mask, 3=rgb, 4=rgba, 5=bgra, 6=argb. */
typedef struct dlimg_ImageView {
    int width;
    int height;
    int channels;
    int stride; /* bytes per row; 0 => width * channel_count */
    uint8_t* pixels;
} dlimg_ImageView;

/* dlimg_gpu selects the accelerator backend (TPU in this build). */
typedef enum dlimg_Backend { dlimg_cpu, dlimg_gpu } dlimg_Backend;

typedef struct dlimg_Options {
    dlimg_Backend backend;
    char const* model_directory;
} dlimg_Options;

typedef enum dlimg_Result { dlimg_success, dlimg_error } dlimg_Result;

/* The complete API surface as a function table (stable across versions;
 * resolve `dlimg_init` and call through the table). */
struct dlimg_Api {
    int (*is_backend_supported)(dlimg_Backend);

    dlimg_Result (*create_environment)(dlimg_Environment*, dlimg_Options const*);
    void (*destroy_environment)(dlimg_Environment);

    /* Embed an image for interactive segmentation (expensive; cached). */
    dlimg_Result (*process_image_for_segmentation)(dlimg_Segmentation*,
                                                   dlimg_ImageView const*,
                                                   dlimg_Environment);
    /* Query masks. Exactly one of `point` (int[2]) / `region` (int[4],
     * x0,y0,x1,y1) is non-null. out_masks is uint8_t*[3]; a null slot 1
     * selects single-mask mode and only slot 0 is written. Multi-mask mode
     * writes 3 masks and 3 accuracies. Buffers are width*height bytes. */
    dlimg_Result (*get_segmentation_mask)(dlimg_Segmentation, int const* point,
                                          int const* region, uint8_t** out_masks,
                                          float* out_accuracies);
    void (*get_segmentation_extent)(dlimg_Segmentation, int* out_extent /*[2]*/);
    void (*destroy_segmentation)(dlimg_Segmentation);

    /* Dichotomous foreground segmentation (BiRefNet). out_mask: w*h bytes. */
    dlimg_Result (*segment_objects)(dlimg_ImageView const*, uint8_t* out_mask,
                                    dlimg_Environment);

    /* Image codecs. Pixels from load_image are owned by the library; free
     * with destroy_image (allocator separation across the ABI). */
    dlimg_Result (*load_image)(char const* filepath, int* out_extent /*[2]*/,
                               int* out_channels, uint8_t** out_pixels);
    dlimg_Result (*save_image)(dlimg_ImageView const*, char const* filepath);
    uint8_t* (*create_image)(int width, int height, int channels);
    void (*destroy_image)(uint8_t const* pixels);

    /* Message for the most recent dlimg_error on this thread. */
    char const* (*last_error)(void);

    /* -- Extensions past the reference-compatible prefix (append-only; a
     * client built against the reference ABI never reads past last_error,
     * so the 13-entry prefix above stays byte-compatible). -- */

    /* Automatic mask generation ("segment everything"): every object mask
     * of the processed image, best-first. thresholds: float[3] =
     * {predicted-IoU min, stability min, NMS box-IoU max}. out_masks is
     * uint8_t*[max_masks], each slot width*height bytes; out_accuracies
     * float[max_masks]. Writes *out_count <= max_masks masks. */
    dlimg_Result (*generate_masks)(dlimg_Segmentation,
                                   float const* thresholds /*[3]*/,
                                   int max_masks, uint8_t* const* out_masks,
                                   float* out_accuracies, int* out_count);

    /* Batched multi-prompt decode: n prompts against ONE processed image's
     * cached embedding in a single device program (one dispatch + one
     * fetch). prompts: int[n*4] — {x, y, unused, unused} for a point,
     * {x0, y0, x1, y1} for a box; is_region: int[n] (0 = point, 1 = box).
     * out_masks: uint8_t*[n], each width*height bytes (best mask per
     * prompt); out_accuracies: float[n] or NULL. */
    dlimg_Result (*compute_mask_batch)(dlimg_Segmentation,
                                       int const* prompts /*[n*4]*/,
                                       int const* is_region /*[n]*/, int n,
                                       uint8_t* const* out_masks,
                                       float* out_accuracies);
};

DLIMG_API struct dlimg_Api const* dlimg_init(void);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* DLIMGEDIT_TPU_CAPI_H_ */
