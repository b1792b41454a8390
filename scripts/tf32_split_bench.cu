// The 3xTF32 split at fragment load, timed on the card (scripts/tf32_split_bench.py
// builds and runs it): 8 warps a block, one block an SM, each warp running
// the f32 message chains' inner loop (csrc/chain_tf32.cuh mma_slab: 16 k8
// steps x 8 n-tile pairs, a 16-byte shared-memory load of two B fragments,
// three mma.sync m16n8k8 TF32 a tile) with the B operand split by each
// variant: V 0 one TF32 product, no split (the rate without the split's
// work); 9 hi and lo split ahead of time in shared memory (no split work,
// twice the bytes); 1 cvt.rna.tf32.f32 for hi and lo; 2 hi and lo rounded
// by an integer add on the bits; 5 hi by the add, lo = x - hi as it is (the
// kernels' `split`); 3 Veltkamp's split (x * 8193, round to nearest even).
// Prints each variant's TF32 rate, its share of the 495 TFLOP/s peak and
// the f32 rate it gives (a third of it).
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ uint32_t cvt_rna(float x){uint32_t r;asm("cvt.rna.tf32.f32 %0, %1;":"=r"(r):"f"(x));return r;}
__device__ __forceinline__ void mma(float*c,const uint32_t*a,uint32_t b0,uint32_t b1){
 asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3},{%4,%5,%6,%7},{%8,%9},{%0,%1,%2,%3};\n"
 :"+f"(c[0]),"+f"(c[1]),"+f"(c[2]),"+f"(c[3]):"r"(a[0]),"r"(a[1]),"r"(a[2]),"r"(a[3]),"r"(b0),"r"(b1));}
template<int V> __device__ __forceinline__ void split(float x,uint32_t&hi,uint32_t&lo){
 if(V==1){hi=cvt_rna(x);lo=cvt_rna(x-__uint_as_float(hi));}
 else if(V==5){hi=(__float_as_uint(x)+0x1000u)&0xffffe000u;lo=__float_as_uint(x-__uint_as_float(hi));}
 else if(V==2){hi=(__float_as_uint(x)+0x1000u)&0xffffe000u;lo=__float_as_uint(x-__uint_as_float(hi))+0x1000u;}
 else {float s=__fmul_rn(x,8193.0f); float h=__fsub_rn(s,__fsub_rn(s,x)); hi=__float_as_uint(h); lo=__float_as_uint(x-h);}
}
// V=0: single pass, no split; V=9: pre-split (hi, lo loaded from smem)
template<int V> __global__ void __launch_bounds__(256,1) k(const float* W,float* out,int iters){
 extern __shared__ float4 s[];
 for(int i=threadIdx.x;i<16384/4*(V==9?2:1);i+=256) s[i]=reinterpret_cast<const float4*>(W)[i%4096];
 __syncthreads();
 int lane=threadIdx.x&31;
 float acc[16][4]={};
 uint32_t ahi[4],alo[4];
 for(int j=0;j<4;j++){ahi[j]=__float_as_uint(1.0f+lane*j);alo[j]=__float_as_uint(1e-4f*j);}
 for(int it=0;it<iters;it++){
  #pragma unroll 2
  for(int kk=0;kk<16;kk++){
   #pragma unroll
   for(int np=0;np<8;np++){
    if(V==9){
     float4 h=s[(kk*8+np)*64+lane], l=s[(kk*8+np)*64+32+lane];
     mma(acc[2*np],alo,__float_as_uint(h.x),__float_as_uint(h.y));mma(acc[2*np],ahi,__float_as_uint(l.x),__float_as_uint(l.y));mma(acc[2*np],ahi,__float_as_uint(h.x),__float_as_uint(h.y));
     mma(acc[2*np+1],alo,__float_as_uint(h.z),__float_as_uint(h.w));mma(acc[2*np+1],ahi,__float_as_uint(l.z),__float_as_uint(l.w));mma(acc[2*np+1],ahi,__float_as_uint(h.z),__float_as_uint(h.w));
    } else {
     float4 v=s[(kk*8+np)*32+lane];
     if(V==0){mma(acc[2*np],ahi,__float_as_uint(v.x),__float_as_uint(v.y));mma(acc[2*np+1],ahi,__float_as_uint(v.z),__float_as_uint(v.w));}
     else{
      uint32_t h0,l0,h1,l1,h2,l2,h3,l3; split<V>(v.x,h0,l0);split<V>(v.y,h1,l1);split<V>(v.z,h2,l2);split<V>(v.w,h3,l3);
      mma(acc[2*np],alo,h0,h1);mma(acc[2*np],ahi,l0,l1);mma(acc[2*np],ahi,h0,h1);
      mma(acc[2*np+1],alo,h2,h3);mma(acc[2*np+1],ahi,l2,l3);mma(acc[2*np+1],ahi,h2,h3);
     }
    }
   }
  }
 }
 float t=0; for(int i=0;i<16;i++)for(int j=0;j<4;j++)t+=acc[i][j];
 out[blockIdx.x*256+threadIdx.x]=t;
}
template<int V> void run(const char* name,const float*W,float*out,int sms){
 int smem=(V==9?2:1)*65536; cudaFuncSetAttribute(k<V>,cudaFuncAttributeMaxDynamicSharedMemorySize,smem);
 int iters=200; k<V><<<sms,256,smem>>>(W,out,2); cudaDeviceSynchronize();
 cudaEvent_t a,b; cudaEventCreate(&a);cudaEventCreate(&b); cudaEventRecord(a);
 k<V><<<sms,256,smem>>>(W,out,iters); cudaEventRecord(b); cudaEventSynchronize(b);
 float ms; cudaEventElapsedTime(&ms,a,b);
 double mmas=(double)sms*8*iters*16*16*(V==0?1:3);
 printf("%s: %.3f ms, %.1f TFLOP/s of tf32 mma (%.1f%% of 495), f32-equivalent %.1f TFLOP/s; err %s\n",name,ms,mmas*2048/ms/1e9,mmas*2048/ms/1e9/495*100,
   mmas*2048/ms/1e9/(V==0?1:3),cudaGetErrorString(cudaGetLastError()));
}
int main(){int sms;cudaDeviceGetAttribute(&sms,cudaDevAttrMultiProcessorCount,0);
 float*W,*out;cudaMalloc(&W,65536);cudaMalloc(&out,sms*256*4);cudaMemset(W,0,65536);
 run<0>("1xTF32 no split",W,out,sms);run<9>("3xTF32 pre-split in smem",W,out,sms);
 run<1>("3xTF32 cvt.rna hi, lo",W,out,sms);
 run<2>("3xTF32 integer add hi, lo",W,out,sms);run<5>("3xTF32 integer add hi, lo as it is (kernels)",W,out,sms);
 run<3>("3xTF32 Veltkamp",W,out,sms);run<0>("1xTF32 no split, again",W,out,sms);
 run<5>("3xTF32 integer add hi, lo as it is (kernels), again",W,out,sms);return 0;}
