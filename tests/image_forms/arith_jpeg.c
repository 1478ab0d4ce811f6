/* Arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive) through the
 * system libjpeg, which PIL cannot ask for.  Built and run only by
 * make_fixtures.py:
 *
 *   cc -O2 -o arith_jpeg arith_jpeg.c -ljpeg
 *   arith_jpeg W H C SAMPLING PROGRESSIVE RESTART DC_L DC_U AC_K QUALITY
 *              IN.raw OUT.jpg
 *
 * C: 1 (gray), 3 (RGB in, YCbCr out) or 4 (CMYK, Adobe marker);
 * SAMPLING: 444 or 420 (luma / first component 2x2); RESTART: MCUs
 * between restart markers (0: none); DC_L, DC_U, AC_K: the conditioning
 * written in DAC for every table.  IN.raw holds H * W * C bytes. */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

int main(int argc, char **argv) {
  if (argc != 13) {
    fprintf(stderr, "usage: see the comment at the top\n");
    return 2;
  }
  int w = atoi(argv[1]), h = atoi(argv[2]), c = atoi(argv[3]);
  int sub420 = strcmp(argv[4], "420") == 0, prog = atoi(argv[5]);
  int restart = atoi(argv[6]), dc_l = atoi(argv[7]), dc_u = atoi(argv[8]);
  int ac_k = atoi(argv[9]), quality = atoi(argv[10]);
  size_t n = (size_t)w * h * c;
  unsigned char *px = malloc(n);
  FILE *in = fopen(argv[11], "rb");
  if (!in || fread(px, 1, n, in) != n) return 3;
  fclose(in);
  FILE *out = fopen(argv[12], "wb");
  if (!out) return 4;

  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = c;
  cinfo.in_color_space = c == 1 ? JCS_GRAYSCALE : c == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  cinfo.arith_code = TRUE;
  cinfo.optimize_coding = FALSE;
  cinfo.restart_interval = restart;
  for (int i = 0; i < NUM_ARITH_TBLS; ++i) {
    cinfo.arith_dc_L[i] = (UINT8)dc_l;
    cinfo.arith_dc_U[i] = (UINT8)dc_u;
    cinfo.arith_ac_K[i] = (UINT8)ac_k;
  }
  for (int i = 0; i < cinfo.num_components; ++i) {
    cinfo.comp_info[i].h_samp_factor = (i == 0 && sub420) ? 2 : 1;
    cinfo.comp_info[i].v_samp_factor = (i == 0 && sub420) ? 2 : 1;
  }
  if (prog) jpeg_simple_progression(&cinfo);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = px + (size_t)cinfo.next_scanline * w * c;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  free(px);
  return 0;
}
