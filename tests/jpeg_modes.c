/* A test-only JPEG writer for the modes Pillow reads but does not write:
 * arithmetic-coded sequential and progressive files (with DAC
 * conditioning and restart intervals), lossless files (predictors 1-7,
 * point transforms), arithmetic transcodes of existing files (the
 * coefficients unchanged, as jpegtran -arithmetic gives them) and gray
 * files holding any coefficient blocks (to hold an IDCT to libjpeg's).
 *
 * It is compiled at run time by tests/jpeg_modes.py against the libjpeg
 * that Pillow bundles (libjpeg-turbo 3.1, whose jpeg_enable_lossless the
 * system's older jpeglib.h does not declare), so the files are the ones
 * Pillow's own library writes. The interface is plain C for ctypes;
 * every function returns 0, or -1 with the library's message in `err`.
 */

#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

/* libjpeg-turbo 3.0 and later; the system header may predate it */
extern void jpeg_enable_lossless(j_compress_ptr cinfo,
                                 int predictor_selection_value,
                                 int point_transform);

struct guard {
  struct jpeg_error_mgr pub;
  jmp_buf jump;
  char *err;
};

static void fail(j_common_ptr cinfo) {
  struct guard *g = (struct guard *)cinfo->err;
  (*cinfo->err->format_message)(cinfo, g->err);
  longjmp(g->jump, 1);
}

static void quiet(j_common_ptr cinfo, int level) {
  (void)cinfo;
  (void)level;
}

/* dac: 3 bytes a table (L, U, K) for tables 0 and 1, or NULL */
static void set_dac(j_compress_ptr c, const unsigned char *dac) {
  if (!dac) return;
  for (int t = 0; t < 2; t++) {
    c->arith_dc_L[t] = dac[3 * t];
    c->arith_dc_U[t] = dac[3 * t + 1];
    c->arith_ac_K[t] = dac[3 * t + 2];
  }
}

/* Pixels (h rows of w * comps bytes, in the colour space `in_space`, a
 * J_COLOR_SPACE) to a JPEG in `jpeg_space`. sampling: 2 ints (h, v) a
 * component. restart: an interval in MCUs, or (negative) in MCU rows.
 * psv > 0: lossless with that predictor and point transform pt. */
int mrt_jpeg_write(const unsigned char *px, int w, int h, int comps,
                   int in_space, int jpeg_space, int quality, int arith,
                   int progressive, int restart, const int *sampling,
                   const unsigned char *dac, int psv, int pt,
                   unsigned char **out, unsigned long *out_size, char *err) {
  struct jpeg_compress_struct c;
  struct guard g;
  c.err = jpeg_std_error(&g.pub);
  g.pub.error_exit = fail;
  g.pub.emit_message = quiet;
  g.err = err;
  *out = NULL;
  *out_size = 0;
  if (setjmp(g.jump)) {
    jpeg_destroy_compress(&c);
    return -1;
  }
  jpeg_create_compress(&c);
  jpeg_mem_dest(&c, out, out_size);
  c.image_width = (JDIMENSION)w;
  c.image_height = (JDIMENSION)h;
  c.input_components = comps;
  c.in_color_space = (J_COLOR_SPACE)in_space;
  jpeg_set_defaults(&c);
  jpeg_set_colorspace(&c, (J_COLOR_SPACE)jpeg_space);
  jpeg_set_quality(&c, quality, TRUE);
  for (int i = 0; i < c.num_components; i++) {
    c.comp_info[i].h_samp_factor = sampling[2 * i];
    c.comp_info[i].v_samp_factor = sampling[2 * i + 1];
  }
  c.arith_code = arith ? TRUE : FALSE;
  set_dac(&c, dac);
  if (restart >= 0)
    c.restart_interval = (unsigned int)restart;
  else
    c.restart_in_rows = -restart;
  if (psv > 0) jpeg_enable_lossless(&c, psv, pt);
  if (progressive) jpeg_simple_progression(&c);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = (JSAMPROW)(px + (size_t)c.next_scanline * w * comps);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  return 0;
}

/* A JPEG's coefficients written again, arithmetic-coded or Huffman,
 * sequential or progressive, with the restart interval and DAC given. */
int mrt_jpeg_transcode(const unsigned char *data, unsigned long n, int arith,
                       int progressive, int restart, const unsigned char *dac,
                       unsigned char **out, unsigned long *out_size,
                       char *err) {
  struct jpeg_decompress_struct d;
  struct jpeg_compress_struct c;
  struct guard g;
  d.err = jpeg_std_error(&g.pub);
  c.err = &g.pub;
  g.pub.error_exit = fail;
  g.pub.emit_message = quiet;
  g.err = err;
  *out = NULL;
  *out_size = 0;
  int made = 0;
  if (setjmp(g.jump)) {
    if (made) jpeg_destroy_compress(&c);
    jpeg_destroy_decompress(&d);
    return -1;
  }
  jpeg_create_decompress(&d);
  jpeg_mem_src(&d, data, n);
  jpeg_save_markers(&d, JPEG_APP0 + 14, 0xFFFF);
  jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&d);
  jpeg_create_compress(&c);
  made = 1;
  jpeg_mem_dest(&c, out, out_size);
  jpeg_copy_critical_parameters(&d, &c);
  c.arith_code = arith ? TRUE : FALSE;
  c.optimize_coding = FALSE;
  set_dac(&c, dac);
  c.restart_interval = (unsigned int)restart;
  if (progressive) jpeg_simple_progression(&c);
  jpeg_write_coefficients(&c, coefs);
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  return 0;
}

void mrt_jpeg_free(unsigned char *p) { free(p); }

/* A gray JPEG (the size of `base`, a gray JPEG) holding the quantized
 * coefficients `coefs` (its blocks row by row, 64 each in natural order)
 * under the quantization table `quant` (natural order, 16-bit values
 * allowed), Huffman-coded with optimized tables: any block the format can
 * carry, to hold a decoder's IDCT to libjpeg's. */
int mrt_jpeg_with_coefficients(const unsigned char *base, unsigned long n,
                               const short *coefs, const unsigned short *quant,
                               unsigned char **out, unsigned long *out_size,
                               char *err) {
  struct jpeg_decompress_struct d;
  struct jpeg_compress_struct c;
  struct guard g;
  d.err = jpeg_std_error(&g.pub);
  c.err = &g.pub;
  g.pub.error_exit = fail;
  g.pub.emit_message = quiet;
  g.err = err;
  *out = NULL;
  *out_size = 0;
  int made = 0;
  if (setjmp(g.jump)) {
    if (made) jpeg_destroy_compress(&c);
    jpeg_destroy_decompress(&d);
    return -1;
  }
  jpeg_create_decompress(&d);
  jpeg_mem_src(&d, base, n);
  jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr *arrays = jpeg_read_coefficients(&d);
  jpeg_component_info *comp = d.comp_info;
  long b = 0;
  for (JDIMENSION r = 0; r < comp->height_in_blocks; r++) {
    JBLOCKARRAY row = (*d.mem->access_virt_barray)((j_common_ptr)&d, arrays[0], r, 1, TRUE);
    for (JDIMENSION x = 0; x < comp->width_in_blocks; x++, b++)
      memcpy(row[0][x], coefs + b * 64, 64 * sizeof(short));
  }
  jpeg_create_compress(&c);
  made = 1;
  jpeg_mem_dest(&c, out, out_size);
  jpeg_copy_critical_parameters(&d, &c);
  JQUANT_TBL *t = c.quant_tbl_ptrs[comp->quant_tbl_no];
  for (int k = 0; k < 64; k++) t->quantval[k] = quant[k];
  c.optimize_coding = TRUE;
  jpeg_write_coefficients(&c, arrays);
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  return 0;
}
